"""Multi-tier KV block manager: the G2 host and G3 disk tiers and the G4
write-through (pool.py), the G4 remote block store and its client
(remote.py, served by ``python -m dynamo_tpu_torch.kvbm``), the sharded G4
fleet (distributed.py), the global KV directory (directory.py) and the
block storage formats (layout.py)."""
