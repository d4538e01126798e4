from .methods import (
    EuclideanRepellency,
    KernelFastRepellency,
    KernelRepellency,
    RandomNoiseRepellency,
    RepellencyConfig,
    RepellencyProcessor,
    SparseRepellency,
    apply_repellency,
    get_repellency_method,
    register_conditioning_method,
)
from .lsh import LSHash, LSHRepellency  # registers the 'lsh' method

__all__ = ["EuclideanRepellency", "KernelFastRepellency", "KernelRepellency",
           "LSHash", "LSHRepellency", "RandomNoiseRepellency",
           "RepellencyConfig", "RepellencyProcessor", "SparseRepellency",
           "apply_repellency", "get_repellency_method",
           "register_conditioning_method"]
