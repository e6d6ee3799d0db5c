"""One reader a per-layer metric, each in the file of its name."""
