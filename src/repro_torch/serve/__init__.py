"""serve — the slot-batched serving engine."""
