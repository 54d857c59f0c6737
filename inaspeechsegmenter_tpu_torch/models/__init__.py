from .keras_h5 import KerasImportError, load_native, read_h5, save_native
from .native import ImportedModel
from .registry import DMODELS, ModelNotFoundError, get_remote, load_patch_model

__all__ = ["ImportedModel", "read_h5", "save_native", "load_native",
           "KerasImportError", "get_remote", "load_patch_model",
           "ModelNotFoundError", "DMODELS"]
