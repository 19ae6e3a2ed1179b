"""launch — command-line drivers, the production mesh and the dry-run."""
