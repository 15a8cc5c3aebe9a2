"""Host-side data handling of the port (numpy, no device work)."""
