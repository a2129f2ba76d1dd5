"""The topk kernel's share of its roofline in the traced stretch."""
from roofline import share


def read(rec):
    return share(rec, 'topk')
