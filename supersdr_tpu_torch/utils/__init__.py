"""Cross-cutting utilities on the port: device tracing, block timing,
structured logging."""
