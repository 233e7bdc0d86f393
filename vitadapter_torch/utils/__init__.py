"""Host-side helpers: resizing, weights."""
