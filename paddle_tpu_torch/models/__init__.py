from .convert import load_reference_state
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "load_reference_state"]
