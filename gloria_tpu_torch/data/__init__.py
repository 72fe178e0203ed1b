"""Host-side text and image preprocessing."""
