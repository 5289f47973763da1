"""Device kernels, copies and fills per value-and-grad evaluation, counted in
the traced stage."""


def read(rec):
    if not rec["device"]:
        return None
    return len(rec["device"]) / rec["evaluations"]
