"""recall_at_10: |answer ∩ exact top 10| / 10 over the distinct queries
checked (check.py), each at its first checked answer."""


def read(rec):
    value = rec["checks"]["recall_at_10"]
    return None if value != value else value
