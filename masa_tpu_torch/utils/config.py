"""Taken from ``masa_tpu/utils/config.py`` (the JAX reference).

INI-style configuration ([global]/[stageN] sections) mirroring the
reference's configs system (configs/Configs.hpp:30-97, ConfigParser.cpp,
configs/default.cfg) — and actually wired into JobConfig, unlike the
reference where it was parsed but mostly unused (SURVEY §2)."""

from __future__ import annotations

import configparser
import dataclasses


@dataclasses.dataclass
class StageConfig:
    ram_size: int | None = None
    disk_size: int | None = None
    block_pruning: bool | None = None
    maximum_partition: int | None = None
    stage4_strategy: str | None = None


@dataclasses.dataclass
class EngineConfig:
    ram_size: int = 1 << 30
    disk_size: int = 16 << 30
    block_pruning: bool = True
    sra_compression: str = "none"
    flush_deepness: int = 7
    backend: str = "auto"
    stages: dict = dataclasses.field(default_factory=dict)


_SIZES = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}


def parse_size(s: str) -> int:
    s = s.strip().upper()
    for suffix, mult in _SIZES.items():
        if s.endswith(suffix):
            return int(float(s[:-1]) * mult)
    return int(s)


def load_config(path: str) -> EngineConfig:
    cp = configparser.ConfigParser()
    cp.read(path)
    cfg = EngineConfig()
    if cp.has_section("global"):
        g = cp["global"]
        if "ram-size" in g:
            cfg.ram_size = parse_size(g["ram-size"])
        if "disk-size" in g:
            cfg.disk_size = parse_size(g["disk-size"])
        if "block-pruning" in g:
            cfg.block_pruning = g.getboolean("block-pruning")
        if "flush-deepness" in g:
            cfg.flush_deepness = g.getint("flush-deepness")
        if "sra-compression" in g:
            cfg.sra_compression = g["sra-compression"].strip().lower()
        if "backend" in g:
            cfg.backend = g["backend"]
    for k in range(1, 7):
        sec = f"stage{k}"
        if cp.has_section(sec):
            s = cp[sec]
            sc = StageConfig()
            if "ram-size" in s:
                sc.ram_size = parse_size(s["ram-size"])
            if "disk-size" in s:
                sc.disk_size = parse_size(s["disk-size"])
            if "block-pruning" in s:
                sc.block_pruning = s.getboolean("block-pruning")
            if "maximum-partition" in s:
                sc.maximum_partition = s.getint("maximum-partition")
            if "strategy" in s:
                sc.stage4_strategy = s["strategy"]
            cfg.stages[k] = sc
    return cfg


def apply_to_job_config(cfg: EngineConfig, jcfg) -> None:
    jcfg.ram_limit = cfg.ram_size
    jcfg.disk_limit = cfg.disk_size
    jcfg.block_pruning = cfg.block_pruning
    jcfg.sra_compression = cfg.sra_compression
    jcfg.flush_deepness = cfg.flush_deepness
    jcfg.backend = cfg.backend
    s4 = cfg.stages.get(4)
    if s4 and s4.maximum_partition is not None:
        jcfg.stage4_max_partition = s4.maximum_partition
    if s4 and s4.stage4_strategy is not None:
        jcfg.stage4_strategy = s4.stage4_strategy.upper()
