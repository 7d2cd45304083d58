"""The session store, its codecs and parallel ingest: port against JAX on
the CPU.

The port's copies of ``repro.data.codecs``, ``store``, ``ingest`` and the
chunked generators of ``synthetic`` must write the JAX package's bytes:
every codec encodes to JAX's stream and round-trips to the bit, and
``ingest_synthetic`` writes stores whose shard files are byte-equal and
whose manifests are equal as JSON, for 1 and 2 workers and codecs ``auto``
and ``raw``. Each package's ``SessionStore`` reads the other's store. The
store's fail-closed paths (checksums, truncation, schema drift, corrupt
compressed streams, the uncommitted directory) follow JAX's tests.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

from repro.data import SessionStore as JaxStore
from repro.data import ShardCorruptionError as JaxCorruptionError
from repro.data import SyntheticConfig as JaxConfig
from repro.data import codecs as jcodecs
from repro.data import ingest_synthetic as jax_ingest
from repro.data import iter_click_log_chunks as jax_chunks
from repro.data import write_session_store as jax_write
from repro.data.synthetic import chunk_sizes as jax_chunk_sizes
from repro.data.synthetic import synthesize_chunk as jax_synthesize
from repro_torch.data import (SessionStore, SessionStoreWriter,
                              ShardCorruptionError, SyntheticConfig,
                              generate_click_log, ingest_synthetic,
                              iter_click_log_chunks, synthesize_chunk,
                              write_session_store)
from repro_torch.data import codecs
from repro_torch.data.ingest import ingest_chunks, merge_shard_groups
from repro_torch.data.store import MANIFEST_NAME
from repro_torch.data.synthetic import chunk_sizes
from repro_torch.testing import corrupt_shard_file, truncate_tail

CFG = dict(n_sessions=900, n_queries=15, docs_per_query=8, positions=6,
           behavior="dbn", seed=17)
SPLITS = {"train": 0.8, "val": 0.1, "test": 0.1}


@pytest.fixture(scope="module")
def log():
    data, _ = generate_click_log(SyntheticConfig(**CFG))
    return data


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def assert_trees_identical(a, b):
    """Shard files byte-equal, manifests equal as JSON."""
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert set(ta) == set(tb)
    for rel in sorted(ta):
        if os.path.basename(rel) == MANIFEST_NAME:
            assert json.loads(ta[rel]) == json.loads(tb[rel]), rel
        else:
            assert ta[rel] == tb[rel], rel


# -- codecs ---------------------------------------------------------------

def _columns():
    rng = np.random.default_rng(0)
    return {
        "bool_mask": rng.random((64, 7)) < 0.8,
        "float_clicks": (rng.random((64, 7)) < 0.2).astype(np.float32),
        "int64_binary": rng.integers(0, 2, (64, 7)),
        "positions": np.tile(np.arange(1, 8, dtype=np.int64), (64, 1)),
        "small_ids": rng.integers(0, 50, (64, 7)),
        "random_float": rng.standard_normal((64, 7)).astype(np.float32),
        "int32_ids": rng.integers(0, 2 ** 31 - 1, (64, 7), dtype=np.int32),
        "odd_bits": rng.random(13) < 0.5,  # not a multiple of 8 elements
    }


COLUMNS = sorted(_columns())


@pytest.mark.parametrize("codec", ["raw", "zlib", "bitpack"])
@pytest.mark.parametrize("column", COLUMNS)
def test_codec_round_trips_to_the_bit_and_equals_jax(codec, column):
    arr = _columns()[column]
    if codec == "bitpack" and not codecs.is_binary(arr):
        with pytest.raises(ValueError):
            codecs.encode(codec, arr)
        with pytest.raises(ValueError):
            jcodecs.encode(codec, arr)
        return
    stored = codecs.encode(codec, arr)
    assert stored == jcodecs.encode(codec, arr)
    back = codecs.decode(codec, stored, arr.dtype, arr.shape)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert back.tobytes() == arr.tobytes()
    if codec == "bitpack":
        assert len(stored) == (arr.size + 7) // 8


@pytest.mark.parametrize("column", COLUMNS)
def test_encode_auto_chooses_and_encodes_as_jax(column):
    arr = _columns()[column]
    chosen, stored = codecs.encode_auto(arr)
    assert (chosen, stored) == jcodecs.encode_auto(arr)
    assert codecs.is_binary(arr) == jcodecs.is_binary(arr)
    back = codecs.decode(chosen, stored, arr.dtype, arr.shape)
    assert back.tobytes() == arr.tobytes()


@pytest.mark.parametrize("codec", ["raw", "bitpack", "zlib"])
def test_decode_fails_closed_on_a_mis_sized_stream(codec):
    arr = np.ones((16, 4), np.float32)
    stored = codecs.encode(codec, arr)
    with pytest.raises(ValueError):
        codecs.decode(codec, stored, np.float32, (17, 4))


def test_corrupt_zlib_stream_and_unknown_codec_fail_closed():
    stored = bytearray(codecs.encode("zlib", np.arange(64)))
    stored[3] ^= 0xFF
    with pytest.raises(ValueError):
        codecs.decode("zlib", bytes(stored), np.int64, (64,))
    with pytest.raises(ValueError):
        codecs.encode("lz4", np.arange(3))
    with pytest.raises(ValueError):
        codecs.decode("lz4", b"", np.int64, (0,))


def test_zlib_is_taken_only_past_the_acceptance_threshold():
    rng = np.random.default_rng(1)
    incompressible = rng.integers(0, 2 ** 62, 512)
    assert codecs.encode_auto(incompressible)[0] == "raw"
    assert codecs.encode_auto(np.zeros(512, np.int64) + 7)[0] == "zlib"
    assert codecs.ZLIB_ACCEPT == jcodecs.ZLIB_ACCEPT
    assert codecs.ZLIB_LEVEL == jcodecs.ZLIB_LEVEL


# -- the chunked generators ------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 128, 300, 900, 2000])
def test_chunked_generators_equal_jax(chunk):
    port = list(iter_click_log_chunks(SyntheticConfig(**CFG), chunk))
    ref = list(jax_chunks(JaxConfig(**CFG), chunk))
    assert chunk_sizes(SyntheticConfig(**CFG), chunk) == jax_chunk_sizes(
        JaxConfig(**CFG), chunk) == [len(c["clicks"]) for c in port]
    assert len(port) == len(ref)
    for c, (a, b) in enumerate(zip(port, ref)):
        assert set(a) == set(b)
        addressed = synthesize_chunk(SyntheticConfig(**CFG), c, chunk)
        jax_addressed = jax_synthesize(JaxConfig(**CFG), c, chunk)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (c, k)
            assert addressed[k].tobytes() == a[k].tobytes(), (c, k)
            assert jax_addressed[k].tobytes() == a[k].tobytes(), (c, k)
    with pytest.raises(IndexError):
        synthesize_chunk(SyntheticConfig(**CFG), len(port), chunk)
    with pytest.raises(ValueError):
        chunk_sizes(SyntheticConfig(**CFG), 0)


# -- ingest: byte-identical to JAX ------------------------------------------

@pytest.mark.parametrize("splits", [None, SPLITS], ids=["whole", "splits"])
@pytest.mark.parametrize("codec", ["auto", "raw"])
@pytest.mark.parametrize("workers", [1, 2])
def test_ingest_writes_jax_bytes(tmp_path, workers, codec, splits):
    kw = dict(chunk_sessions=110, shard_rows=200, splits=splits,
              codec=codec, workers=workers)
    port = ingest_synthetic(SyntheticConfig(**CFG), str(tmp_path / "port"),
                            **kw)
    jax_ingest(JaxConfig(**CFG), str(tmp_path / "jax"), **kw)
    assert_trees_identical(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert set(port) == ({""} if splits is None else set(splits))
    store = port[""] if splits is None else port["train"]
    assert store.metadata["ingest_workers"] == workers
    assert store.metadata["store_codec"] == codec


def test_parallel_ingest_equals_serial_up_to_the_worker_count(tmp_path):
    for workers in (1, 3):
        ingest_synthetic(SyntheticConfig(**CFG), str(tmp_path / str(workers)),
                         chunk_sessions=70, shard_rows=90, splits=SPLITS,
                         workers=workers)
    a, b = tree_bytes(str(tmp_path / "1")), tree_bytes(str(tmp_path / "3"))
    assert set(a) == set(b)
    for rel in a:
        if rel.endswith(MANIFEST_NAME):
            ma, mb = json.loads(a[rel]), json.loads(b[rel])
            assert ma["metadata"].pop("ingest_workers") == 1
            assert mb["metadata"].pop("ingest_workers") == 3
            assert ma == mb
        else:
            assert a[rel] == b[rel], rel


def test_more_workers_than_shards(tmp_path):
    stores = ingest_synthetic(SyntheticConfig(**CFG), str(tmp_path / "s"),
                              chunk_sessions=300, shard_rows=500, workers=4)
    jax_ingest(JaxConfig(**CFG), str(tmp_path / "j"), chunk_sessions=300,
               shard_rows=500, workers=4)
    assert stores[""].n_shards == 2
    assert_trees_identical(str(tmp_path / "s"), str(tmp_path / "j"))


def test_ingest_chunks_equals_the_concatenated_chunks(tmp_path):
    cfg = SyntheticConfig(**CFG)
    fn = functools.partial(synthesize_chunk, cfg, chunk_sessions=250)
    stores = ingest_chunks(fn, chunk_sizes(cfg, 250), str(tmp_path / "s"),
                           shard_rows=160, codec="raw", workers=2)
    whole = stores[""].read_all()
    want = [synthesize_chunk(cfg, c, 250) for c in range(4)]
    for k in whole:
        np.testing.assert_array_equal(
            whole[k], np.concatenate([w[k] for w in want]), err_msg=k)


def test_ingest_chunks_refuses_bad_plans(tmp_path):
    fn = functools.partial(synthesize_chunk, SyntheticConfig(**CFG),
                           chunk_sessions=100)
    with pytest.raises(ValueError):
        ingest_chunks(fn, [], str(tmp_path / "a"))
    with pytest.raises(ValueError):
        ingest_chunks(fn, [100], str(tmp_path / "b"), workers=0)
    with pytest.raises(ValueError):
        ingest_chunks(fn, [100], str(tmp_path / "c"), codec="lz4")
    with pytest.raises(ValueError):  # the plan disagrees with the chunks
        ingest_chunks(fn, [99], str(tmp_path / "d"))
    with pytest.raises(ValueError):  # a split that receives nothing
        ingest_chunks(fn, [2], str(tmp_path / "e"),
                      splits={"train": 0.99, "val": 0.01})


def test_merge_shard_groups_orders_and_refuses_overlaps_and_gaps():
    def e(i):
        return {"name": f"shard_{i:05d}", "rows": 1}

    assert [x["name"] for x in merge_shard_groups([[e(2)], [e(0), e(1)]])
            ] == ["shard_00000", "shard_00001", "shard_00002"]
    for groups in ([[e(0)], [e(0)]], [[e(0)], [e(2)]], []):
        with pytest.raises(ValueError):
            merge_shard_groups(groups)


# -- each package reads the other's store -----------------------------------

@pytest.mark.parametrize("codec", ["auto", "raw"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, log, codec, writer):
    where = str(tmp_path / "s")
    write = write_session_store if writer == "port" else jax_write
    write(log, where, shard_rows=128, codec=codec, metadata={"who": writer})
    port, ref = SessionStore(where, verify=True), JaxStore(where, verify=True)
    assert port.manifest == ref.manifest
    assert port.stored_nbytes() == ref.stored_nbytes()
    a, b = port.read_all(), ref.read_all()
    for k in log:
        assert a[k].dtype == b[k].dtype == log[k].dtype
        assert a[k].tobytes() == b[k].tobytes() == log[k].tobytes(), k
    for i in range(port.n_shards):
        for k in log:
            assert port.shard_codec(i, k) == ref.shard_codec(i, k)


@pytest.mark.parametrize("shard_rows", [64, 128, 1000])
def test_write_session_store_writes_jax_bytes(tmp_path, log, shard_rows):
    write_session_store(log, str(tmp_path / "p"), shard_rows=shard_rows,
                        codec="auto")
    jax_write(log, str(tmp_path / "j"), shard_rows=shard_rows, codec="auto")
    assert_trees_identical(str(tmp_path / "p"), str(tmp_path / "j"))


# -- the store's own contract (JAX's tests/test_store.py) --------------------

def test_chunked_append_equals_single_append(tmp_path, log):
    one = write_session_store(log, str(tmp_path / "one"), shard_rows=300)
    with SessionStoreWriter(str(tmp_path / "many"), shard_rows=300) as w:
        for lo in range(0, 900, 170):
            w.append({k: v[lo:lo + 170] for k, v in log.items()})
    many = SessionStore(str(tmp_path / "many"))
    a, b = one.read_all(), many.read_all()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tree_bytes(str(tmp_path / "one")) == tree_bytes(
        str(tmp_path / "many"))


def test_writer_rejects_schema_drift_and_empty_stores(tmp_path, log):
    with pytest.raises(ValueError):
        with SessionStoreWriter(str(tmp_path / "a"), shard_rows=100) as w:
            w.append(log)
            w.append({**log, "clicks": log["clicks"].astype(np.float64)})
    with pytest.raises(KeyError):
        with SessionStoreWriter(str(tmp_path / "b"), shard_rows=100) as w:
            w.append(log)
            w.append({**log, "extra": log["clicks"]})
    with pytest.raises(RuntimeError):
        SessionStoreWriter(str(tmp_path / "c")).close()
    with pytest.raises(ValueError):
        SessionStoreWriter(str(tmp_path / "d"), shard_rows=0)
    with pytest.raises(ValueError):
        SessionStoreWriter(str(tmp_path / "e"), codec="zlib")


def test_an_uncommitted_directory_is_not_a_store(tmp_path, log):
    with pytest.raises(RuntimeError):
        with SessionStoreWriter(str(tmp_path / "s"), shard_rows=100) as w:
            w.append(log)
            raise RuntimeError("crash mid-ingest")
    with pytest.raises(FileNotFoundError):
        SessionStore(str(tmp_path / "s"))


def test_reingest_drops_the_stale_manifest_first(tmp_path, log):
    where = str(tmp_path / "s")
    write_session_store(log, where, shard_rows=100)
    w = SessionStoreWriter(where, shard_rows=100)
    assert not os.path.exists(os.path.join(where, MANIFEST_NAME))
    w.append(log)
    w.close()
    assert SessionStore(where).rows == 900


@pytest.mark.parametrize("codec", ["raw", "auto"])
def test_corruption_and_truncation_fail_closed(tmp_path, log, codec):
    where = str(tmp_path / "s")
    write_session_store(log, where, shard_rows=300, codec=codec)
    SessionStore(where).verify()
    corrupt_shard_file(where, shard=1, column="query_doc_ids", seed=3)
    store = SessionStore(where)
    with pytest.raises(ShardCorruptionError):
        store.verify()
    store.verify(index=0)
    with pytest.raises(JaxCorruptionError):
        JaxStore(where).verify(index=1)
    truncate_tail(os.path.join(where, "shard_00002", "clicks.bin"))
    with pytest.raises(ShardCorruptionError):
        SessionStore(where).open_shard(2)


def test_a_compressed_column_that_keeps_its_size_fails_closed(tmp_path, log):
    where = str(tmp_path / "s")
    store = write_session_store(log, where, shard_rows=900, codec="auto")
    column = next(k for k in log if store.shard_codec(0, k) == "zlib")
    corrupt_shard_file(where, shard=0, column=column, byte_offset=2)
    with pytest.raises(ShardCorruptionError):
        SessionStore(where).open_shard(0)


def test_corrupt_shard_file_is_replayable_and_equals_jax(tmp_path, log):
    from repro.testing import corrupt_shard_file as jax_corrupt

    for who, corrupt in (("p", corrupt_shard_file), ("j", jax_corrupt)):
        write_session_store(log, str(tmp_path / who), shard_rows=300)
        info = corrupt(str(tmp_path / who), shard=1, n_flips=3, seed=9)
        assert info["column"] == "clicks" and len(info["offsets"]) == 3
    assert tree_bytes(str(tmp_path / "p")) == tree_bytes(str(tmp_path / "j"))


def test_a_v1_manifest_reads_as_raw_and_newer_versions_are_refused(
        tmp_path, log):
    where = str(tmp_path / "s")
    write_session_store(log, where, shard_rows=300, codec="raw")
    path = os.path.join(where, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    manifest["format_version"] = 1
    for shard in manifest["shards"]:
        shard.pop("codecs")
        shard.pop("nbytes")
    with open(path, "w") as f:
        json.dump(manifest, f)
    back = SessionStore(where, verify=True).read_all()
    for k in log:
        np.testing.assert_array_equal(back[k], log[k])
    manifest["format_version"] = 3
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError):
        SessionStore(where)


def test_split_ingest_partitions_the_log(tmp_path):
    stores = ingest_synthetic(SyntheticConfig(**CFG), str(tmp_path / "s"),
                              chunk_sessions=150, shard_rows=200,
                              splits=SPLITS)
    assert sum(s.rows for s in stores.values()) == CFG["n_sessions"]
    assert stores["train"].metadata["split"] == "train"
    assert stores["train"].metadata["synthetic_config"] == \
        dataclasses.asdict(SyntheticConfig(**CFG))
