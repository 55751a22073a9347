"""Multi-device serving of the port (``serve_shard``: one Server over a
``("data", "model")`` mesh of torch devices)."""
