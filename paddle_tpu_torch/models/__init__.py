from .convert import load_reference_state
from .dit import DiT, DiTConfig, dit_b_4, dit_xl_2
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = [
    "LlamaConfig", "LlamaModel", "LlamaForCausalLM",
    "DiT", "DiTConfig", "dit_xl_2", "dit_b_4", "load_reference_state",
]
