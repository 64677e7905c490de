"""The port's device health check (``textgcn_tpu_torch.cli
.device_healthcheck``) against the JAX package's (``textgcn_tpu/cli.py``,
held by ``tests/test_export.py::test_device_healthcheck``), on the CPU.

A healthy probe returns its round trip; a stuck probe raises
``TimeoutError`` at the limit and logs one ERROR after the warning time;
a failing probe's exception surfaces on the caller's thread; a CLI run
logs the probe line before the data load.
"""

import logging
import os
import time

import pytest

from textgcn_tpu_torch import cli
from textgcn_tpu_torch import config as tconfig


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    logger.propagate = True


def test_a_healthy_probe_returns_its_round_trip():
    from textgcn_tpu.cli import device_healthcheck as jax_check
    rtt = cli.device_healthcheck(warn_after_s=60, fail_after_s=0,
                                 device='cpu')
    assert 0 <= rtt < 60
    assert 0 <= jax_check(warn_after_s=60, fail_after_s=0) < 60


def test_a_stuck_probe_raises_at_the_limit():
    from textgcn_tpu.cli import device_healthcheck as jax_check
    for check in (cli.device_healthcheck, jax_check):
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match='unresponsive'):
            check(warn_after_s=60, fail_after_s=0.2,
                  _probe=lambda: time.sleep(3600))
        assert 0.2 <= time.perf_counter() - t0 < 5


def test_a_slow_probe_logs_one_error(caplog, monkeypatch):
    # a CLI run earlier in the process stops the port's logger propagating
    monkeypatch.setattr(logging.getLogger(tconfig.LOGGER_NAME), 'propagate',
                        True)
    caplog.set_level(logging.ERROR, logger=tconfig.LOGGER_NAME)
    rtt = cli.device_healthcheck(warn_after_s=0.05, fail_after_s=0,
                                 _probe=lambda: time.sleep(0.6))
    assert rtt >= 0.6
    errors = [r for r in caplog.records if r.levelno == logging.ERROR]
    assert len(errors) == 1
    assert 'unresponsive' in errors[0].getMessage()
    assert cli.TIMEOUT_ENV in errors[0].getMessage()


def test_the_limits_come_from_the_environment(monkeypatch):
    monkeypatch.setenv(cli.TIMEOUT_ENV, '0.2')
    monkeypatch.setenv(cli.WARN_ENV, '60')
    with pytest.raises(TimeoutError, match='TIMEOUT_S=0.2'):
        cli.device_healthcheck(_probe=lambda: time.sleep(3600))


def test_a_failing_probe_surfaces():
    from textgcn_tpu.cli import device_healthcheck as jax_check
    for check in (cli.device_healthcheck, jax_check):
        with pytest.raises(RuntimeError, match='boom'):
            check(_probe=lambda: (_ for _ in ()).throw(RuntimeError('boom')))


def test_a_cpu_cli_run_logs_the_probe(tmp_path, monkeypatch, dummy_dir):
    """The probe line comes after the device line and before the data
    load (the dataset's line), as in the JAX package's log."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    probes = []
    real = cli.device_healthcheck
    monkeypatch.setattr(cli, 'device_healthcheck', lambda **kw: (
        probes.append(kw) or real(**kw)))
    cli.main(['--model', 'lgcn', '--data', dummy_dir, '--epochs', '1',
              '--batch_size', '16', '--emb_size', '8', '-k', '3',
              '--uid', 'probe', '--no_save'])
    assert probes == [{'device': tconfig.platform_device()}]
    with open(os.path.join('runs', 'dummy', 'probe', 'log.log')) as f:
        lines = f.read().splitlines()
    probe = [i for i, line in enumerate(lines)
             if 'Device backend ready (' in line and ' s probe)' in line]
    device = [i for i, line in enumerate(lines) if 'Device: cpu' in line]
    created = [i for i, line in enumerate(lines) if 'Created model' in line]
    assert len(probe) == 1 and device and created
    assert device[0] < probe[0] < created[0]
