"""Training pieces of the port: the AdamW optimizer and direct surrogate-
gradient SNN training (``surrogate``)."""
