"""Device kernels, copies and fills a step, counted in the traced chunk."""


def read(rec):
    if not rec["device"]:
        return None
    return len(rec["device"]) / rec["steps"]
