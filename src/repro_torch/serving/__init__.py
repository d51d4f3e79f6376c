"""Serving layers of the port beyond the engine (``launch.serve``)."""
