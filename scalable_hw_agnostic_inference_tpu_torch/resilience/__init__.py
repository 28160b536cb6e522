"""Request deadlines and QoS tags (trimmed copies of the reference's
``resilience/deadline.py`` and ``resilience/qos.py``)."""
