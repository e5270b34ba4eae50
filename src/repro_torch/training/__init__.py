"""Training pieces of the port: the AdamW optimizer of the CNN trainer."""
