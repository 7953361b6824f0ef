"""The plain reference that decides ``correct``; it imports nothing of the port."""
