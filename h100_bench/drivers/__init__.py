"""One closed loop per entry point, ``<driver>.py``, named by a mix's ``driver``."""
