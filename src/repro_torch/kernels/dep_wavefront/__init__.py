"""dep_wavefront: segmented dependency-miss counts (the batch engine's
readiness scan)."""
