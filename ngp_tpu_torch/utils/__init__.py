"""Host-side helpers: color spaces and the PNG codec."""
