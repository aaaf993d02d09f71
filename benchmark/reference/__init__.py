"""The plain float32 reference that decides a run's ``correct``."""
