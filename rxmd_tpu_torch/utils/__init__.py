from .timers import Timers  # noqa: F401
