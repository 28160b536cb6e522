"""Model definitions (Llama family) and the byte tokenizer."""
