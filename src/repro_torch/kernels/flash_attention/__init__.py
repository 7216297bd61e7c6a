"""flash_attention: online-softmax attention forward, causal / sliding
window / chunked (kernel B4, gemma3 prefill)."""
