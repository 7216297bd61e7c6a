"""The LM substrate's models, in PyTorch: the attention mixer with a
dense MLP (gemma3-1b) and the rwkv mixer (rwkv6-1.6b) so far. Other
mixers raise ``NotImplementedError`` naming their slice."""
