"""Runtime: the dispatch queue that batches shard work from concurrent
requests into single device launches (two lanes, completers, pinned
staging, failed flushes failed, not moved off the card), the buffer pools under it, and the counted waits
of the request paths on it."""
