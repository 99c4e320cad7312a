from parallel_gcn.utils.checkpoint import load_checkpoint, save_checkpoint
from parallel_gcn.utils.timer import Timer

__all__ = ["Timer", "load_checkpoint", "save_checkpoint"]
