from .app import create_server, main
from .process_keeper import ProcessKeeper, TrainingJob

__all__ = ["create_server", "main", "ProcessKeeper", "TrainingJob"]
