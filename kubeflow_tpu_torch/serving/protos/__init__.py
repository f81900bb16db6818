"""Generated protobuf modules for the serving wire contract."""
