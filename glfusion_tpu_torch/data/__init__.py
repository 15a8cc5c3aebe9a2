"""Data of the port: NIfTI, the dataset index and its builder, the center
manifests, the synthetic corpus, the host loaders (numpy) and the
device-side batch preprocess."""

from glfusion_tpu_torch.data.nifti import (  # noqa: F401
    read_nifti_py, write_nifti)
from glfusion_tpu_torch.data.infos import (  # noqa: F401
    PatientIndex, load_infos)
from glfusion_tpu_torch.data.xlsx import (  # noqa: F401
    load_center_manifest, load_manifest_dir)
from glfusion_tpu_torch.data.synthetic import (  # noqa: F401
    generate_synthetic_dataset)
from glfusion_tpu_torch.data.pipeline import (  # noqa: F401
    AlignedClipLoader,
    AllMaskFrameLoader,
    FullVideoLoader,
    RegressionClipLoader,
    SegFrameLoader,
    TestClipLoader,
    preprocess_batch,
    preprocess_regression_batch,
)
