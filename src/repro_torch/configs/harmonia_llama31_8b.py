"""Paper's own primary eval model: Llama-3.1-8B (Table I/II, Figs. 7-10).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.common import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="harmonia-llama3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=500000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama31-smoke", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, tie_embeddings=False, param_dtype="float32",
)

SPEC = register(ArchSpec(
    arch_id="harmonia-llama3.1-8b", config=CONFIG, smoke=SMOKE,
    source="paper Sec. V-A (Llama family)"))
