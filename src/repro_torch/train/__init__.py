"""train — the port's training pieces (so far the AdamW optimizer that the
tuning loop times)."""
