"""Serving: bucket ladder, dynamic batcher, latency ledger and the engine."""
