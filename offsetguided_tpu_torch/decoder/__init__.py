from .pipeline import PostProcessor

__all__ = ['PostProcessor']
