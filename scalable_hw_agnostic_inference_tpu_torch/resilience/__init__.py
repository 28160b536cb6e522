"""Per-replica resilience (copies of the reference's
``resilience/``): request deadlines, QoS tags and tenant budgets, bounded
admission, the SIGTERM drain and step watchdog, the idempotency cache and
the seeded fault injector."""
