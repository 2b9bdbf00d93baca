"""Model zoo of the port: the dense decoder (qwen3-4b) in this slice."""
