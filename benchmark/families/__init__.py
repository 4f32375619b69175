"""The controller families, one file each, found by a configuration's
``family`` (``benchmark/systems.py`` says what a family file states)."""
