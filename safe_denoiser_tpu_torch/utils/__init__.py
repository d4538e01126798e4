"""Host-side utilities: the run logger and the config readers/writers."""
