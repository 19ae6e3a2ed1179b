"""launch — command-line drivers."""
