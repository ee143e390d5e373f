"""One module per container, ``<container>.py``, named by a configuration's
``container`` (FLCT where a configuration names none): what the harness,
the check and the controls need to know of that container."""
