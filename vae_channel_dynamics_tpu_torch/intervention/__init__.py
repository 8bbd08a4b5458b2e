from .nudger import InterventionHandler

__all__ = ["InterventionHandler"]
