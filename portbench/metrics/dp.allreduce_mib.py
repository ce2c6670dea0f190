"""MiB rank 0 put into collectives per step (``parallel/mesh.TRAFFIC``, the
port's own count, over the window's steps)."""


def read(rec: dict):
    steps, traffic = len(rec.get("ran", ())), rec.get("collectives")
    if not steps or not traffic:
        return None
    return sum(b for _, b in traffic.values()) / steps / 2**20
