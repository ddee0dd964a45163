"""LLM-layer types the port's engine speaks (request/response, tokenizer)."""
