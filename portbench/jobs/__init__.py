"""Window drivers, one per job kind (`traffic/<name>.json`'s "job")."""
