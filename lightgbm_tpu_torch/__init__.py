"""The PyTorch + CUDA port of LightGBM-TPU.

A second package beside ``lightgbm_tpu`` (the JAX reference, which it
never imports): the same model format, training and prediction semantics
in PyTorch, with the TPU's Pallas kernels rewritten by hand for NVIDIA
Hopper (``csrc/``). Entry points run on the CUDA card unless the caller
asks for the CPU (``device_type=cpu``, ``PredictionService(device="cpu")``);
with no card they raise instead of falling back.

Ported so far: training through the host-driven serial learner
(``train``, ``Dataset``, ``Booster(params, train_set)``) on dense numeric
binary and regression data; load a model text, ``Booster.predict`` (raw,
converted or leaf indices); and the prediction service with its HTTP front
(``lightgbm_tpu_torch.serving``).
"""
from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, record_evaluation
from .config import Config, resolve_device
from .engine import train
from .models.serialize import GBDTModel
from .models.tree import Tree
from .utils.log import LightGBMError, register_log_callback

__version__ = "0.1.0"

__all__ = [
    "Booster",
    "Config",
    "Dataset",
    "GBDTModel",
    "LightGBMError",
    "Tree",
    "early_stopping",
    "log_evaluation",
    "record_evaluation",
    "register_log_callback",
    "resolve_device",
    "train",
    "__version__",
]
