"""Mean device ms a sampled batch of the 4-stage net's dilated stem: its
six dilated 3x3 ConvBNs and the concat with their input (the program's
`net.dilated` stage records, one a forward)."""
from program_stages import ms_by_batch


def read(rec):
    ms = ms_by_batch(rec, 'net.dilated')
    return sum(ms.values()) / len(ms) if ms else None
