"""LLM serving layer of the port: protocols, tokenizers, preprocessing,
the worker-side Backend, discovery and the OpenAI HTTP frontend.

The submodules are imported where they are used; importing this package
loads nothing beyond it."""
