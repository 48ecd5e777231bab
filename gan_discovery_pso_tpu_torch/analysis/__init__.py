"""Host-side report writers of the port (matplotlib and PIL are imported
inside the writers)."""
