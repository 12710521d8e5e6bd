"""L3: match / interval / alignment data model + serialization."""
