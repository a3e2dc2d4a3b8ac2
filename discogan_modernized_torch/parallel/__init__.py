from .dp import DataParallel, collectives, reset_collectives

__all__ = ["DataParallel", "collectives", "reset_collectives"]
