"""Mean device ms a sampled batch of the 4-stage net's
squeeze-and-excitation layers, the stacks' `net.se` stage records summed
(four a forward at 4 stacks): fp32 spatial mean, two Linear layers,
sigmoid and the channel scale."""
from program_stages import ms_by_batch


def read(rec):
    ms = ms_by_batch(rec, 'net.se')
    return sum(ms.values()) / len(ms) if ms else None
