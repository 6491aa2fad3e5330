from .models import GPTForCausalLM, TransformerLMConfig
from . import datasets  # noqa: F401
from .datasets import (  # noqa: F401
    Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16,
)

__all__ = ["GPTForCausalLM", "TransformerLMConfig", "Conll05st", "Imdb",
           "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16"]
