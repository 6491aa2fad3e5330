from .models import (  # noqa: F401
    BertForPretraining, BertModel, GPTForCausalLM, GPTModel,
    TransformerLMConfig, bert_base, gpt3_1p3b)
from . import datasets  # noqa: F401
from .datasets import (  # noqa: F401
    Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16,
)

__all__ = ["BertModel", "BertForPretraining", "GPTModel", "GPTForCausalLM",
           "gpt3_1p3b", "bert_base", "TransformerLMConfig", "Conll05st",
           "Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16"]
