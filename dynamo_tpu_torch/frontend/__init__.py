"""The OpenAI frontend process of the serving plane (``python -m
dynamo_tpu_torch.frontend``)."""
