"""Forward FLOPs of the images answered in the window, at the shapes they
ran (twice with flip; padding of partial batches not counted), over the
window's seconds, against the card's bf16 peak."""
from flops import forward_flops
from kernels import PEAK_BF16_FLOPS


def read(rec):
    if not rec.get('seconds') or not rec.get('images_by_shape'):
        return None
    total = sum(n * forward_flops(rec['cfg'], h, w)
                for (h, w), n in rec['images_by_shape'].items())
    if rec.get('flip'):
        total *= 2
    return 100.0 * total / rec['seconds'] / PEAK_BF16_FLOPS
