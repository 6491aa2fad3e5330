"""Legacy pre-2.0 dataset package (a port of ``paddle_tpu/dataset/``;
reference: python/paddle/dataset/ —
reader-creator API deprecated in favor of paddle.io + the class-based
vision/text datasets, but still shipped and imported by fluid-era
code).

Each module exposes the reference reader-creator surface (train/test
return a callable yielding sample tuples) delegating to the modern
Dataset classes, which read local DATA_HOME files and fall back to
deterministic synthetic data in offline environments.
"""
from . import (cifar, common, conll05, flowers, image, imdb, imikolov,  # noqa: F401
               mnist, movielens, uci_housing, voc2012, wmt14, wmt16)

__all__ = []
