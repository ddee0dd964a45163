"""Multi-tier KV block manager: the G2 host and G3 disk tiers (pool.py) and
the block storage formats (layout.py)."""
