"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of ``glfusion_tpu/config.py`` with the same names and
defaults, so one configuration describes the same model in both packages.
The port keeps its own copy: it imports nothing of ``glfusion_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Global 5-structure channel space: (RA, RV, LA, LV, PA).
STRUCTURES = ("RA", "RV", "LA", "LV", "PA")
NUM_CLASSES = len(STRUCTURES)

# Views: '1' = parasternal LV long-axis (PLAX), '2' = PA long-axis,
# '3' = LV short-axis (PSAX), '4' = apical four-chamber (A4C).
ALL_VIEWS = ("1", "2", "3", "4")

# Per-view native label channel count.
VIEW_OUT_CHANNELS = {"1": 2, "2": 1, "3": 2, "4": 4}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the Global_and_Local model.

    Defaults reproduce the reference; the width/depth knobs exist so tests
    can instantiate tiny variants with the same topology.
    """

    views: Sequence[str] = ("1", "3", "4")
    num_classes: int = NUM_CLASSES
    # ResNet-50 backbone (torchvision topology)
    stem_width: int = 64
    block_sizes: Sequence[int] = (3, 4, 6, 3)
    widths: Sequence[int] = (64, 128, 256, 512)
    expansion: int = 4
    # replace_stride_with_dilation=[False, True, True]: layer3/4 stride 1
    dilate_stages: Sequence[bool] = (False, False, True, True)
    # DeepLab ASPP head
    aspp_rates: Sequence[int] = (12, 24, 36)
    aspp_channels: int = 256
    aspp_dropout: float = 0.5
    # TPAVI fusion: inter = in // 2 when None
    tpavi_inter_channels: int | None = None
    # Center-aware local masking weight
    center_aware_weight: float = 20.0
    # Model variant switch of the flagship (arch "glfusion")
    variant: str = "global_and_local"
    # Trainable architecture (models/registry.py; arch_names.SEG_ARCHS)
    arch: str = "glfusion"
    # Compute dtype, float32 or bfloat16 (params stay fp32; the rounding
    # points are listed in models/precision.py).
    dtype: str = "float32"
    # In the port: run the TPAVI products through the hand-written CUDA
    # kernel (glfusion_tpu_torch/csrc/tpavi_fused.cu), in the cheaper of the
    # two contraction orders. Default False: the reassociated θ(φᵀg)/N order
    # on plain matmuls, equal in real arithmetic.
    use_pallas_fusion: bool = False
    # Rematerialize the backbone's bottlenecks (torch.utils.checkpoint), in
    # every stage or in those remat_stages marks.
    remat: bool = False
    remat_stages: Sequence[bool] | None = None

    @property
    def backbone_out_channels(self) -> int:
        return self.widths[-1] * self.expansion

    @property
    def num_views(self) -> int:
        return len(self.views)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data pipeline contract."""

    root: str | None = None  # dataset root with .nii.gz files; None → synthetic
    infos_path: str = "infos/save_infos_reg_v2.npy"
    unlab_infos_path: str = "infos/infos_unlab.npy"
    test_infos_path: str = "infos/test_infos.npy"
    data_list_dir: str = "data_list"
    use_data: Sequence[str] = ("rmyy",)
    # Resize→crop protocol
    resize_hw: int = 144
    crop_hw: int = 112
    clip_length: int = 40
    # regression clip frame count
    reg_clip_frames: int = 48
    # Train dataset epoch multiplier
    train_repeat: int = 4
    # synthetic-data knobs (when root is None)
    synthetic_num_patients: int = 16
    synthetic_raw_hw: int = 160
    synthetic_num_frames: int = 48


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """Optimizer."""

    name: str = "adam"
    lr: float = 3e-4
    weight_decay: float = 1e-5  # torch Adam-style L2 (added to grad pre-moments)
    betas: Sequence[float] = (0.9, 0.999)
    cosine_t_max: int = 100  # epochs


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop. ``mesh_data`` × ``mesh_model`` is the (data, model)
    mesh over the run's processes (``parallel/mesh.py``; -1: every process
    that ``mesh_model`` leaves)."""

    batch_size: int = 8
    num_epochs: int = 100
    seed: int = 6666
    test_views: Sequence[str] = ("1", "3", "4")
    use_cycle: bool = True
    dense_cyc: bool = False
    cycle_weight: float = 1e-2
    cycle_light: bool = False
    remat_supervised: bool = True
    fuse_passes: bool = False
    temporal: bool = False
    cps_weight: float = 1.0
    cycle_target_region: int = 16
    cycle_offset: int = 2
    cycle_chunk: int = 3
    cycle_temperature: float = 10.0
    grad_accum: int = 1
    save_dir: str = "./result/ckpt"
    log_dir: str = "./result/log_info/log_01"
    save_every_epochs: int = 1
    eval_every_epochs: int = 1
    ckpt_keep: Optional[int] = None
    mesh_data: int = -1
    mesh_model: int = 1
    log_histograms: bool = False
    checkify: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def tiny_config(views: Sequence[str] = ("1", "3", "4")) -> Config:
    """A topology-faithful miniature for unit tests and CPU smoke runs."""
    return Config(
        model=ModelConfig(
            views=tuple(views),
            stem_width=8,
            block_sizes=(1, 1, 1, 1),
            widths=(8, 16, 32, 64),
            aspp_rates=(2, 4, 6),
            aspp_channels=16,
            use_pallas_fusion=False,
        ),
        data=DataConfig(
            resize_hw=40,
            crop_hw=32,
            clip_length=8,
            reg_clip_frames=8,
            synthetic_num_patients=4,
            synthetic_raw_hw=48,
            synthetic_num_frames=12,
        ),
        train=TrainConfig(
            batch_size=2,
            num_epochs=2,
            test_views=tuple(views),
            cycle_target_region=4,
            cycle_offset=1,
            cycle_chunk=2,
        ),
    )
