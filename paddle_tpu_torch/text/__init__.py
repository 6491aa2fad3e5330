from .models import GPTForCausalLM, TransformerLMConfig

__all__ = ["GPTForCausalLM", "TransformerLMConfig"]
