"""The program's entry points the generator drives, one module each:
``build(torch, att, defn, traffic, seed, device) -> generator.Entry``, where
``defn`` is the configuration's instance as the reference defines it
(``reference.anemoi.Instance``)."""
