"""The LM substrate's models, in PyTorch: the attention mixer with a
dense MLP (gemma3-1b) so far. Other mixers raise ``NotImplementedError``
naming their slice."""
