"""The PyTorch + CUDA port of LightGBM-TPU.

A second package beside ``lightgbm_tpu`` (the JAX reference, which it
never imports): the same model format, training and prediction semantics
in PyTorch, with the TPU's Pallas kernels rewritten by hand for NVIDIA
Hopper (``csrc/``). Entry points run on the CUDA card unless the caller
asks for the CPU (``device_type=cpu``, ``PredictionService(device="cpu")``);
with no card they raise instead of falling back.

Ported so far: training (``train``, ``Dataset``, ``Booster(params,
train_set)``) through the wave learner on the card and the serial learner
elsewhere: binary, regression, multiclass and cross-entropy objectives,
learning to rank (lambdarank with position debias, rank_xendcg; NDCG and
MAP), bagging and GOSS, quantized gradients, categorical features (pandas
``category`` columns included), DART and random forests; the model's life
cycle: continued
training and bit-identical checkpoint resume (``init_model``,
``checkpoint.checkpoint_callback``), ``cv``, ``Booster.refit``,
``Booster.rollback_one_iter`` and the numerical-health guardrails
(``health_check_policy``); the Booster's predict (raw, converted or leaf indices), model
text and JSON dump, feature importances, score bounds and
``reset_parameter`` (with ``callback.reset_parameter``); prediction early
stopping (``pred_early_stop``); the scikit-learn estimators
(``LGBMRegressor``, ``LGBMClassifier``, ``LGBMRanker``); and the prediction
service with its HTTP front, circuit breaker, replicas and canary
(``lightgbm_tpu_torch.serving``); and the observability layer: telemetry
sessions (``telemetry_dir``), the Prometheus exposition, the flight
recorder, the profiler (``LGBM_TPU_PROFILE``), the cost model
(``perfmodel``), fault injection and the sync sanitizer.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, record_evaluation, reset_parameter
from .config import Config, resolve_device
from .engine import CVBooster, cv, train
from .models.serialize import GBDTModel
from .models.tree import Tree
from .utils.log import LightGBMError, register_log_callback

__version__ = "0.1.0"

_SKLEARN_NAMES = ("LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker")


def __getattr__(name):
    # the estimators import scikit-learn, so only when asked for
    if name in _SKLEARN_NAMES:
        from . import sklearn

        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Booster",
    "CVBooster",
    "Config",
    "Dataset",
    "GBDTModel",
    "LightGBMError",
    "Tree",
    "cv",
    "early_stopping",
    "log_evaluation",
    "record_evaluation",
    "register_log_callback",
    "reset_parameter",
    "resolve_device",
    "train",
    "__version__",
]
