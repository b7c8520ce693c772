"""HTTP API layer (reference: scheduler/src/cook/rest/)."""
