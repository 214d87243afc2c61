"""Checkpoint import: Hugging Face directories (``config.json``,
``tokenizer.json``, ``*.safetensors``) into the port's parameter trees."""
