"""models — the dense llama family on the port's kernels."""
