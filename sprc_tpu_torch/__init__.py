"""sprc_tpu_torch: the PyTorch / CUDA port of sprc_tpu for NVIDIA Hopper.

Same models, state-dict layout, index format and serving surface as
``sprc_tpu``; every Pallas kernel on the ported path is a CUDA C++ kernel
written for Hopper (``csrc/``), built at first use. The package imports
torch and numpy only; importing it builds nothing.

The public surface is ``sprc_tpu``'s: ``registry``, ``extract_features``,
``load_model``, ``load_model_and_preprocess``, ``model_zoo`` and
``__version__``. The registry (which imports nothing) is bound here, over
its module's name, as ``sprc_tpu`` binds it; the rest resolve lazily (a
module ``__getattr__``), so that importing a kernel module
(``sprc_tpu_torch.ops.*``) imports no model.
"""

import importlib

from sprc_tpu_torch.registry import registry

__version__ = "0.1.0"

# name -> the module that holds it
_EXPORTS = {"extract_features": "sprc_tpu_torch.features", "load_model": "sprc_tpu_torch.loader",
            "load_model_and_preprocess": "sprc_tpu_torch.loader",
            "model_zoo": "sprc_tpu_torch.loader"}

__all__ = ["__version__", "registry", *_EXPORTS]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'sprc_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
