"""The port's models: llama generation (``llama``, ``llama_serving``)."""
