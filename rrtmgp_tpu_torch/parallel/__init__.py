"""Column splits over devices (``sharding``) and processes (``distributed``)."""
