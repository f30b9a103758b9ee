from .manager import (CheckpointManager, CheckpointWriteError,
                      restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "CheckpointWriteError", "restore_pytree",
           "save_pytree"]
