"""Faults planted in the program underneath a run, for the tests that see
`correct` come out false and for the readings that set the upper end of a
limit (portbench/readings.py --fault NAME).  The benchmark's own runs
plant none.  Each is a context manager that patches the program's warmup
and restores it on exit."""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextmanager
def warmup_unchanged():
    """Warmup runs none of its iterations: the kernel starts from the
    initial state with the initial step size and a unit mass."""
    from rainier_tpu_torch.sampler import driver

    with _patched(driver.Warmup, "advance", lambda self, n: None):
        yield


@contextmanager
def start_unchanged():
    """Warmup adapts, but hands the kernel the chains' initial state."""
    from rainier_tpu_torch.sampler import driver

    init, product = driver.Warmup.__init__, driver.Warmup.product

    def keep_start(self, *args, **kw):
        init(self, *args, **kw)
        self.first_chain = self.chain

    def initial_state(self):
        return product(self)._replace(chain=self.first_chain)

    with _patched(driver.Warmup, "__init__", keep_start), \
            _patched(driver.Warmup, "product", initial_state):
        yield


@contextmanager
def mass_unchanged():
    """Warmup adapts, but hands the kernel a unit mass."""
    import torch
    from rainier_tpu_torch.sampler import driver
    from rainier_tpu_torch.sampler.mass import diag_mass

    product = driver.Warmup.product

    def unit_mass(self):
        wp = product(self)
        return wp._replace(mass=diag_mass(torch.ones_like(wp.mass.diag)))

    with _patched(driver.Warmup, "product", unit_mass):
        yield


FAULTS = {"warmup_unchanged": warmup_unchanged,
          "start_unchanged": start_unchanged,
          "mass_unchanged": mass_unchanged}
