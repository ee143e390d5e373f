"""The traffic generator; each mix is a data file beside it, ``<traffic>.json``."""
