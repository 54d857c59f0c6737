"""The systems under test, one module per ``system`` of ``configs/``: how
to build the port's object from a configuration, drive it, read its
answers and hold them against the configuration's reference."""
