"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu.

A second package beside ``dynamo_tpu`` (the JAX/Pallas reference, left
unchanged). Module names mirror the reference so a reader finds each
counterpart; inside, the port is PyTorch: plain functions on tensors, an
explicit ``device`` argument, explicit ``torch.Generator``s, and hand-written
CUDA kernels (``csrc/``) where the reference has Pallas kernels.

Entry points run on the GPU unless the caller asks for ``device="cpu"``
(``device.resolve_device``). Importing the package starts nothing and
compiles nothing: kernels are built at first use (``ops/_build.py``).
"""
