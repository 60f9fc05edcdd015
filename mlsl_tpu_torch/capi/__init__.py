"""The port's C entry: ``c_api.cpp`` and its build (``build.py``)."""
