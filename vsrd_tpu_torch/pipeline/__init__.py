"""Per-frame data and the test-time optimization loop."""
