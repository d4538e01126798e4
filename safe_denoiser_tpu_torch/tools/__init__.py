"""Tooling (the reference's mics/ and data/ scripts): run-log parsing and
the fleet shards' merge (``logs``), the negative-bank data loop, CSV
conversion and image grids (``data_prep``)."""
