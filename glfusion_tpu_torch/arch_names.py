"""Trainable-architecture names (import-light), a copy of the JAX
package's ``arch_names.py``: the CLI builds its ``--model`` choices from
them without importing the models. ``REG_ARCHS`` are the ``--reg-model``
names (JAX's ``models/registry.py:317`` and the CLI's choices)."""

AVS_FLAVORS = ("baseline", "transfusion", "model17", "pred_endecoder")
LEGACY_KINDS = ("none", "channel_transformer", "tpavi", "model18", "model20",
                "decouple", "mlp_concat")
# the models/unet.py family; plain `unet` is the multi-view baseline U-Net,
# `unet:plain` is U_Net proper
UNET_KINDS = ("plain", "r2", "att", "r2att")
SEG_ARCHS = (("glfusion", "unet", "multiview_unet", "utnet", "cen",
              "res3dunet")
             + tuple(f"unet:{k}" for k in UNET_KINDS)
             + tuple(f"avs_{f}" for f in AVS_FLAVORS)
             + tuple(f"legacy:{k}" for k in LEGACY_KINDS))
# the video regressors of --mode reg-train|reg-val
REG_ARCHS = ("resnet50pah", "r2plus1d", "timesformer", "resnet50pfs")
