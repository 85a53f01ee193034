"""Config presets: the entries of `mllm_tpu/models/families.py`, copied."""

from __future__ import annotations

from ..core.config import TextConfig

# ---------------------------------------------------------------------------
# Qwen family
# ---------------------------------------------------------------------------

QWEN15_05B = TextConfig(
    model_type="qwen2", vocab_size=151936, hidden_size=1024, intermediate_size=2816,
    num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
    max_position_embeddings=32768, rope_theta=1000000.0, attention_bias=True,
    tie_word_embeddings=True, bos_token_id=151643, eos_token_id=151645,
)

QWEN25_05B = TextConfig(
    model_type="qwen2", vocab_size=151936, hidden_size=896, intermediate_size=4864,
    num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
    max_position_embeddings=32768, rope_theta=1000000.0, attention_bias=True,
    tie_word_embeddings=True, bos_token_id=151643, eos_token_id=151645,
)

QWEN25_15B = TextConfig(
    model_type="qwen2", vocab_size=151936, hidden_size=1536, intermediate_size=8960,
    num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
    max_position_embeddings=32768, rope_theta=1000000.0, attention_bias=True,
    tie_word_embeddings=True, bos_token_id=151643, eos_token_id=151645,
)

QWEN25_7B = TextConfig(
    model_type="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    max_position_embeddings=32768, rope_theta=1000000.0, attention_bias=True,
    tie_word_embeddings=False, bos_token_id=151643, eos_token_id=151645,
)

QWEN3_06B = TextConfig(
    model_type="qwen3", vocab_size=151936, hidden_size=1024, intermediate_size=3072,
    num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8, head_dim=128,
    max_position_embeddings=40960, rope_theta=1000000.0, attention_bias=False,
    qk_norm=True, tie_word_embeddings=True, bos_token_id=151643, eos_token_id=151645,
)

# DeepSeek-R1-Distill-Qwen — qwen2 arch
DS_QWEN2_15B = QWEN25_15B.replace(model_type="qwen2", tie_word_embeddings=False)

# ---------------------------------------------------------------------------
# LLaMA family
# ---------------------------------------------------------------------------

TINYLLAMA_11B = TextConfig(
    model_type="llama", vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
    max_position_embeddings=2048, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
)

LLAMA2_7B = TextConfig(
    model_type="llama", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    max_position_embeddings=4096, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
)

LLAMA32_1B = TextConfig(
    model_type="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=131072, rope_theta=500000.0, attention_bias=False,
    tie_word_embeddings=True, bos_token_id=128000, eos_token_id=128009,
    rope_scaling=(
        ("factor", 32.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
        ("original_max_position_embeddings", 8192), ("rope_type", "llama3"),
    ),
)

SMOLLM_17B = TextConfig(
    model_type="llama", vocab_size=49152, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=24, num_attention_heads=32, num_key_value_heads=32,
    max_position_embeddings=2048, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=True, bos_token_id=0, eos_token_id=0,
)

SMOLLM2_135M = TextConfig(
    model_type="llama", vocab_size=49152, hidden_size=576, intermediate_size=1536,
    num_hidden_layers=30, num_attention_heads=9, num_key_value_heads=3,
    max_position_embeddings=8192, rope_theta=100000.0, attention_bias=False,
    tie_word_embeddings=True, bos_token_id=1, eos_token_id=2,
)

DCLM_1B = TextConfig(  # llama-style arch
    model_type="llama", vocab_size=50432, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
    max_position_embeddings=2048, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=False, bos_token_id=0, eos_token_id=0,
)

# ---------------------------------------------------------------------------
# Mistral
# ---------------------------------------------------------------------------

MISTRAL_7B = TextConfig(
    model_type="mistral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=32768, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
)

# ---------------------------------------------------------------------------
# Gemma
# ---------------------------------------------------------------------------

GEMMA_2B = TextConfig(
    model_type="gemma", vocab_size=256000, hidden_size=2048, intermediate_size=16384,
    num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
    max_position_embeddings=8192, rope_theta=10000.0, attention_bias=False,
    hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
    embedding_multiplier=2048**0.5, bos_token_id=2, eos_token_id=1,
)

GEMMA2_2B = TextConfig(
    model_type="gemma2", vocab_size=256000, hidden_size=2304, intermediate_size=9216,
    num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4, head_dim=256,
    max_position_embeddings=8192, rope_theta=10000.0, attention_bias=False,
    hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True, post_norm=True,
    sliding_window=4096, sliding_window_pattern=2,
    logit_softcap=30.0, attn_logit_softcap=50.0,
    embedding_multiplier=2304**0.5, bos_token_id=2, eos_token_id=1,
)

# ---------------------------------------------------------------------------
# StableLM / Phi-3 / PhoneLM
# ---------------------------------------------------------------------------

STABLELM2_16B = TextConfig(
    model_type="stablelm", vocab_size=100352, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=24, num_attention_heads=32, num_key_value_heads=32,
    max_position_embeddings=4096, rope_theta=10000.0, attention_bias=True,
    o_proj_bias=False, norm_type="layernorm", rope_partial=0.25,
    tie_word_embeddings=False, bos_token_id=100257, eos_token_id=100257,
)

PHI3_MINI = TextConfig(
    model_type="phi3", vocab_size=32064, hidden_size=3072, intermediate_size=8192,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    max_position_embeddings=4096, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=32000,
)

PHONELM_15B = TextConfig(
    model_type="phonelm", vocab_size=49152, hidden_size=2048, intermediate_size=6816,
    num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
    max_position_embeddings=2048, rope_theta=10000.0, attention_bias=False,
    hidden_act="relu2", tie_word_embeddings=True, bos_token_id=1, eos_token_id=2,
)

PRESETS: dict[str, TextConfig] = {
    "qwen1.5-0.5b": QWEN15_05B,
    "qwen2.5-0.5b": QWEN25_05B,
    "qwen2.5-1.5b": QWEN25_15B,
    "qwen2.5-7b": QWEN25_7B,
    "qwen3-0.6b": QWEN3_06B,
    "ds-qwen2-1.5b": DS_QWEN2_15B,
    "tinyllama-1.1b": TINYLLAMA_11B,
    "llama2-7b": LLAMA2_7B,
    "llama3.2-1b": LLAMA32_1B,
    "smollm-1.7b": SMOLLM_17B,
    "smollm2-135m": SMOLLM2_135M,
    "dclm-1b": DCLM_1B,
    "mistral-7b": MISTRAL_7B,
    "gemma-2b": GEMMA_2B,
    "gemma2-2b": GEMMA2_2B,
    "stablelm2-1.6b": STABLELM2_16B,
    "phi3-mini": PHI3_MINI,
    "phonelm-1.5b": PHONELM_15B,
}
