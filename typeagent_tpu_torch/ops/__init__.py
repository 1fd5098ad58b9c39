"""Device programs of the store: appendable buffers and exact top-k."""
