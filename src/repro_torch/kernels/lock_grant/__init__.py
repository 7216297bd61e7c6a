"""Segmented FIFO lock grant (ORTHRUS CC lanes): CUDA kernel + plain version."""
