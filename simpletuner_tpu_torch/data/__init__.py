"""The port's data layer: storage backends (``backends/``)."""
