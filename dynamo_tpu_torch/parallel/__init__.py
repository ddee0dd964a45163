"""Tensor parallelism: the TP group's layout (mesh.py) and its collectives
(comm.py). Counterpart of the reference's parallel/ package for its ``tp``
mesh axis; the dispatch replay that keeps the ranks in step is
runtime/multihost.py."""
