from .methods import (
    KernelFastRepellency,
    RepellencyConfig,
    RepellencyProcessor,
    apply_repellency,
    get_repellency_method,
)

__all__ = ["KernelFastRepellency", "RepellencyConfig", "RepellencyProcessor",
           "apply_repellency", "get_repellency_method"]
