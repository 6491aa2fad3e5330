"""The ``nn`` surface of the port. So far only the gradient clips the
optimizers take (``grad_clip=``); layers are ``torch.nn`` modules."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
