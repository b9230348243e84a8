"""Per-workload configuration files; each exposes ``get_config()``."""
