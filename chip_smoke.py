#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tendermint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only] [--ab-parent DIR]

Both signature planes run the same phases, each fatal on failure:
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
     print each kernel function's registers and spills as ptxas reports
     them, and the card's name and power limit; build the native host prep
     (native/prep.c, with cc) and print its cc line;
  2. hold each kernel against its plain PyTorch version on the card on an
     edge batch (exact equality: the arithmetic is integer): tampered
     rows, the ZIP-215 edge encodings for ed25519 (small-order, undecodable
     and non-canonical R, R plus a point of order 8), the RFC 9496 bad
     encodings, a missing marker bit, s >= L, an honest R made
     non-canonical, negated or random, and a zero row for sr25519; the
     cache hits also with a tampered k, a slot whose oks is false, slots
     counted from the end (slot - C) and the edge slots -1, -5, -C,
     -C - 1, INT32_MIN, C, C + 3, INT32_MAX, the plain version handed the
     same raw slots (both wrap, then clamp, as the reference's gather),
     and on sr25519 an honest R made odd and non-canonical after the host
     prep (the bitmap and every hit); and the bitmap against the plane's
     pure-Python oracle; the cache fill
     and hit at every pubkey-cache split (TM_TPU_PK_SPLIT 4, 1, 2, 8), and
     the cached RLC at S = 2, 4, 8; fail_count (the sharded path's fail
     count) on edge bitmaps of 1 to 10,240 rows, verdicts and 1-8 counts;
  3. the main path: verify_commit on ed25519 and on sr25519 validator sets
     of 150, 1,000 and 10,000 validators (valid, and with one tampered
     signature that must be reported at its index), every kernel's launch
     counter set to 0 just before each call and read just after, and held
     to the launches that call must make;
  4. each kernel against its plain version again, on the rows phase 3's
     commits give it (16384 rows for the uncached bitmap, 1024 for the
     cache fill and the cache hit through the main path's own cache, both
     for the RLC, in both verdicts with one z_raw), exact equality and the
     tampered row alone invalid; the same calls timed with CUDA events
     beside the plain version, the bound and the launches, the RLC's
     device time by step (tables, windows, reduce, tail: torch.profiler
     by kernel name) and each uncached bitmap's (tables, ladder); the
     host prep of the 1,000- and 10,000-validator commits on both routes,
     the native C and the Python that TM_TPU_NATIVE=0 selects, which must
     give the same rows, precheck and RLC scalars, timed by part at 10,000
     in turns; the valid 10,000-validator verify_commit split into the
     commit loop, the host prep, the copies and the kernel with its sync,
     on both routes in turns, each call held to its one RLC launch; and
     the end-to-end verify_commit wall times; that call through the engine
     against direct dispatch, in turns; with --ab-parent DIR (a git
     archive of another commit, unpacked inside the repo), the RLC kernels, the
     uncached bitmaps (8, 2,560, 10,240 and 16,384 rows, with their
     steps), the split fills (1,024 keys at S = 2, 4, 8 and 10,240 at S =
     4) and the single-table fills (1,024, 4,096 and 10,240 keys), whose
     tables must hash the same in every turn, and the cache hits (1,024
     rows at S = 1, 2, 4, 8, and row 15's 10,240 and 2,560 rows at S = 1
     and 4) of that tree against this one's on the same rows, in turns
     parent, new, new, parent, each a process of its own ("ab:" lines), and
     in this tree's turns the single-table hits' two-launch layout and
     their kernels at every block shape, and both designs of the
     single-table fills (one-lane and quad-split decoders), whose bytes
     must equal the entry point's, with the SASS instruction counts of one
     field product each way;
  5. the other cache geometries, S = 1, 2 and 8, each through a new cache
     of that split: verify_commit on the 150-validator commit and on the
     tampered 1,000-validator one, exact launches (the single-table
     kernels at S = 1), and the split's fill and hit against their plain
     versions on the rows that commit gives them, timed;
  6. the cached RLC (TM_TPU_MSM_CACHE=on, ed25519) at S = 2, 4 and 8: the
     valid 1,000-validator commit with the knob off, then on (fill and
     cached RLC, then the cached RLC alone), the tampered one (cached RLC,
     then the cache hit), the 10,000-validator one (its keys overflow the
     cache: the uncached RLC), exact launches; at S = 1 the knob takes the
     uncached RLC; the cached RLC against its plain version at 1024 rows
     in both verdicts with one z_raw, timed;
  7. the sharded path (parallel/) on two meshes, make_mesh() (the card) and
     make_mesh(4, device="cuda:0") (four shards on it): verify_batch_sharded
     on the 10,000-validator commits of both planes (the bitmap equal to the
     single-card one, the tampered row alone false, the verdict flipped);
     verify_batch_sharded_cached on the 1,000-validator commits at S = 4 and
     S = 1 (the fill once, on the first call, then a hit a shard) and on the
     10,000-validator one, whose keys overflow the cache (the uncached path);
     verify_batch_sharded_rlc on the ed25519 1,000- and 10,000-validator
     commits and on 10 signatures over four shards, two of padding only;
     verify_batch_sharded_local in subprocesses, one rank on NCCL and four
     ranks on gloo with their kernels on the card, each rank holding a
     quarter of the tampered 10,000-validator commit; then each kernel of the
     path against its plain version at the sharded shapes, 10,240 rows and a
     shard of 2,560, exact and timed, fail_count beside torch.sum, and
     verify_batch_sharded against the single-card verify_batch end to end;
  8. the cutover autotune (ops/engine.py) in a fresh process with the
     cutovers unpinned: a 4-signature batch verify starts the probe on
     the card, its thread is joined, and its cutovers must follow the
     reference's formula from its two timings, with no recorded
     exception and exactly its 4 bitmap launches;
  9. the coalescing engine (ops/engine.py) on the card: (a) on each plane,
     three 67-validator commits, then four 1,000-validator ones with one
     tampered, each set verified by concurrent verify_commit callers
     queued behind a first job that holds the dispatch worker, so they
     form one group (coalesced_group_size must show it): every caller's
     verdict and tampered index equal direct dispatch's
     (TM_TPU_ENGINE=off), and the launches exactly those of one call over
     the combined rows; (b) three 20-signature jobs, 60 rows, one host
     group, no launch; (c) in a fresh process with TM_TPU_DEVOBS=1, a valid
     1,000-validator call copies to the card exactly its inputs' bytes,
     residency is above zero after a cache fill, and the build events are
     one load of each library loaded and one nvcc run and load of the one
     kernel built; (d) wall times, engine against direct dispatch in turns,
     beside the card's name and power limit: 8 threads x 150-validator
     ed25519 commits (a light-client server), 4 threads x 1,000-validator
     ones (blocksync's verify-ahead) and one 10,000-validator call, with
     the launches a commit and the engine's overlap_ratio;
 10. the light client and the hashes on the card: (a) on each plane, a
     light chain of 16 heights over 150 validators of equal power (the
     Cosmos Hub's active set), fully populated headers whose commits sign
     header.hash(), the set changing once at height 9 (one key swapped
     by update_with_change_set); verify_adjacent on every consecutive
     pair, verify_non_adjacent and verify from 1 to 16 at the default trust
     level of 1/3, each held to the launches its routing gives (the
     101-signature commit check a cache fill on the first sight of a key,
     then hits; the 51-signature trusting check below the device cutover,
     none), and the rejections with the reference's error classes: a
     data_hash forged after signing and the old set supplied
     (ErrInvalidHeader), a tampered signature (ErrInvalidHeader naming its
     index), an expired trusted header (ErrOldHeaderExpired) and a rival
     set in which the trusted validators hold a third of their power
     (ErrNewValSetCantBeTrusted); (b) the 10,000-validator set's hash()
     cold and memoized, and its leaves' root, proofs and a 64-index
     multiproof on the native route and under TM_TPU_NATIVE=0 in turns,
     the same bytes on both, every proof verifying and a tampered one
     failing; (c) BASELINE.json config 4, mixed key types: verify_commit
     on 100 ed25519 and 50 secp256k1 validators under an ed25519 and a
     secp256k1 proposer, the valid commit accepted and a tampered
     secp256k1 and a tampered ed25519 signature reported at their index,
     serially, so with no launch; the secp256k1 route ("cryptography" or
     "softcrypto") printed beside the wall times;
 11. the light client (light/client.py), its stores and providers, and
     evidence verification (evidence/verify.py) on the card: on each plane
     a chain of 32 heights over 150 validators of which a third (50) is
     swapped out at heights 9, 17 and 25, served by LocalProvider over
     stand-in stores (ChainStore); from trust at height 1 a LightClient
     verifies to 32 skipping (the bisection 1 -> 32 failing the trusting
     check, 1 -> 16, 16 -> 32 failing at exactly a third, 16 -> 24,
     24 -> 32, as bisection_model works out from the sets), sequentially
     (31 adjacent checks) and backwards from 32 to 20 (a hash-chain walk),
     over a MemLightStore and over DBLightStore(MemDB()), each held to the
     heights it fetches and persists; then with an honest, a lunatic (the
     common set re-signs height 32 with a forged app_hash) and an
     equivocating (the same set signs another data_hash) witness: each
     lying one raises ErrLightClientAttack, leaves only the trust root
     persisted and reports its evidence to both providers; then a full
     node's verify_evidence accepts both pieces of evidence and a
     duplicate vote, and refuses a tampered total power (accepted after
     regenerate()), a header rewritten after signing, an unknown common
     height, a forged vote signature and a forged commit signature. Each
     call is held to its outcome and its launches (the 101-signature checks
     on the card, the 51-signature trusting checks on the host); each
     sync's verifier calls, the detections and the evidence checks are
     timed beside the card's name and power limit;
 12. the state layer (state/, store/blockstore.py, evidence/pool.py, abci/)
     on the card, BASELINE.json config 3: on each plane a source node
     (BlockExecutor over the kvstore app through LocalClient, StateStore,
     BlockStore and EvidencePool over FileDBs) builds 16 heights over a
     genesis of 1,000 validators of equal power (blocks from
     create_proposal_block with three kv transactions each, every commit
     signed by the height's set; a val: transaction at 5 adds a validator,
     sr25519-prefixed on that plane; a double sign at 8, reported with
     report_conflicting_votes, becomes evidence at update, rides block 9
     and costs its validator one power) at set-up; then (a) a fresh node
     over its own FileDBs replays the chain as blocksync does (load_block,
     save_block, apply_block), each call held to its launches (none at
     height 1, one RLC at each later height, the evidence checked on the
     host) and each height to the source's app hash, state_to_json, tx
     results hash and the validator set of H + 2 after each change; (b)
     the eleven altered headers of tests/test_state_execution.py at heights
     1 (no launch) and 12 (the proposer and the time, checked after the
     LastCommit, one RLC each), a LastCommit with signature #417 tampered
     (RLC, fill, hit; the reference's error naming the index) and the
     committed evidence proposed again (EvidenceError); (c) a LightClient
     over a LocalProvider on the replica's stores verifies 1 -> 16 skipping,
     alone and beside a lunatic witness, whose attack evidence the node's
     EvidencePool.add_evidence accepts; the reopened FileDBs give the same
     state, block store and pool. The split of apply_block over heights
     2-16, the replay's blocks per second, load_block and the source's
     create_proposal_block are timed beside the card's name and power
     limit;
 13. blocksync (blocksync/) on the port's p2p layer (p2p/), over phase 12's
     source chains: (a) a fresh node's BlockSyncReactor, on a recording
     stub channel, is handed blocks 1-16 through its pool and syncs 1-15
     in 15 calls of _try_sync_one, each height held to the source's store
     bytes, app hash and state_to_json, every call to its RLC launches and
     rows (a light check of second.LastCommit, 667-668 signatures, at
     height 1 and through the verify-ahead after it, one validate_block
     LastCommit check a height from 2; 29 launches); (b) block 12 served
     by a second peer with LastCommit signature #2 altered: refused with
     the reference's error, both senders reported, heights 11 and 12
     redone, the sync completed from an honest third peer (the failed
     verify-ahead's RLC and the cached bitmap); (c) the seen commit of
     height 12 as an ExtendedCommit with 1,000 extension signatures,
     through _validate_ext_commit under TM_TPU_ENGINE=off: honest (two
     RLCs), an extension signature and a vote signature altered (two RLCs
     and the cached bitmap, refused), then honest through the engine (its
     launches printed); (d) a server and a syncing node, each a reactor on
     the port's Router over one MemoryNetwork, sync 15 blocks to
     on_caught_up with (a)'s launches and rows: blocks/s, the time to
     on_caught_up and the split of a block (the light check's synchronous
     call or the verify-ahead's dispatch and wait, make_part_set,
     save_block, apply_block and the server's load_block) beside the
     card's name and power limit;
 14. consensus on one node (consensus/, mempool/, privval/), on each plane:
     a genesis of 150 validators of equal power; the node is a
     ConsensusState over BlockExecutor(device=cuda), the kvstore through
     LocalClient, StateStore and BlockStore over FileDBs, a FilePV holding
     the key that proposes height 4, a WAL on disk and a TxMempool with
     EngineTxPreVerifier; ConsensusNet plays the other 149 (proposals from
     create_proposal_block, every prevote and precommit signed on a process
     pool). (a) 8 heights driven on this thread through add_peer_message,
     process_all and a manual ticker, every call of the node held to its
     launches (none at height 1, a fill and a hit at 2, a hit a height
     after) and every height to its block ID and to a shadow replica's app
     hash and state_to_json (applied with TM_TPU_CRYPTO=off); the WAL holds
     an EndHeight for each; (b) on ed25519, three admission batches through
     check_tx_batch before heights 3, 5 and 7: 1,024 envelopes of 1,024
     account keys (one RLC), 1,024 with #517 tampered (RLC, fill, hit;
     #517 rejected before the app) and 32 (no launch), each committed by
     its height and removed by update; (c) at height 9 a proposal whose
     LastCommit has signature #77 altered (a nil prevote, the reference's
     error naming the index), a prevote with a bad signature (dropped, no
     launch), a validator's two prevotes (report_conflicting_votes), and,
     with every device entry point raising a kernel wrapper's ValueError,
     round 1's proposal through the consumer routine: on_fatal gets it and
     no prevote of round 1 is signed; (d) a fresh state store and kvstore
     replay the 8 stored heights through the Handshaker (7 hits), equal to
     the node's app hash and state, and a second ConsensusState repairs the
     torn WAL and replays it from EndHeight 8 (2 hits); (e) a fresh node
     started with start() and the real ticker at tests/test_consensus.py's
     fast timeouts decides 8 heights against a network answering from its
     own thread (7 hits): heights/s and the split of a height (add_vote's
     host vote checks, validate_block, process_proposal, apply_block,
     save_block, the WAL's fsyncs, create_proposal_block, make_part_set),
     the node's own time a height (its consensus thread's busy time) and
     the network stand-in's, beside the card's name and power limit;
 15. a network over TCP (p2p/transport_tcp.py, secret_connection.py,
     pex.py, the consensus, mempool and evidence reactors), on each plane:
     phase 14's 150 validators at generous timeouts; four validator nodes,
     each a process of its own (NetNode: phase 14's node layers on the card,
     a router on a TcpTransport at 127.0.0.1 with a secret connection on
     every link, the four reactors), holding the keys that propose heights
     2-5; NetHarness, in this process, plays the other 146 over TCP (its
     proposals, then every prevote and precommit, on phase 14's signing
     pool). (a) every node and the harness start from node 0's address and
     PEX completes the mesh: each link's handshake ms, the AEAD route; (b)
     8 heights (ed25519) or 4 (sr25519), every node committing the same
     blocks and the replica's app hash and state, each node's launches held
     height by height to the model of the batches it dispatched (rows
     printed) and to the prediction (none at 1; a fill and a hit at 2; a
     hit a height); (c) ed25519: at height 2 node 0 admits 1,024 envelopes
     (one RLC) and a batch with #517 tampered (RLC, fill, hit), the others
     admit both from the mempool gossip in 2-8 RLCs, each envelope once on
     the card, #517 never gossiped; (d) a validator's two prevotes sent to
     two nodes become DuplicateVoteEvidence, gossiped and committed (host
     checks); a lunatic attack at a committed height, added at node 0, is
     gossiped and checked on the card by every node (one hit); (e) with
     node 3's device entry points failing, a gossiped admission's, a
     gossiped attack's and its consensus's faults reach its on_fatal, no
     peer is reported and it signs no prevote; (f) heights/s of the
     network, each node's busy and CPU ms, AEAD seal and open ms and bytes,
     votes and duplicates received and the card's ms a height, beside the
     card's name and power limit;
 16. the node as its operators run it (node/, rpc/, config/, pubsub/,
     eventbus/, indexer/, cli.py), on each plane: `python -m
     tendermint_tpu_torch testnet --validators 150` writes the homes
     (genesis patched to phase 15's timeouts, a 30 s propose timeout), `init seed` and `init full`
     two more; a seed process and four validator processes started by
     `start` (the fourth through cli_launcher, which can fail its device
     entry points on a trigger file), RPC and Prometheus on ephemeral ports,
     each knowing only the seed; NetHarness plays the other 146 from their
     priv_validator_key.json and proposes every block. (a) PEX through the
     seed meshes them, every node leaves blocksync for consensus; the time
     from `start` to the first RPC answer; (b) 8 heights (ed25519) or 3
     (sr25519): each node's launches from its /metrics
     (kernel_launches_total, the engine's rows by path) held window by
     window (none at 1, a fill and a hit at 2, a hit a height, its rows the
     LastCommit's), block, commit, validators, block_results, abci_query and
     tx_search equal on every node at every height, a NewBlock on each
     node's WebSocket for every height; (c) ed25519: 1,024 envelopes in one
     JSON-RPC batch POST to node 0's broadcast_tx_async, then 1,024 with
     #517 tampered: every node's rows sum to the envelopes it admitted,
     each batch on the plane its size takes, #517 refused at node 0 and in
     no node's unconfirmed_txs; broadcast_tx_commit of one more returns its
     height; tx and tx_search find all 2,048 on every node; (d) a lunatic
     attack to node 0's broadcast_evidence, one 101-row hit on every node
     (node 0's, the gossip's), listed in the next block; an equivocation
     committed as DuplicateVoteEvidence (host); (e) the fourth node's device
     entry points failing, broadcast_tx_sync of an envelope there is
     answered -32603 and its log shows the halt; the other three commit two
     more heights; (f) ed25519: a full node from `init full` blocksyncs,
     switches to consensus and commits the top block, its rows held
     exactly, its fills and hits as predicted; (g) heights/s, each node
     process's CPU ms a height, the launcher node's consensus-thread and
     card ms a height, the RPC's latency by route, broadcast_tx_commit, the
     WebSocket's lag, the admission batches and the full node's blocks/s,
     beside the card's name and power limit;
 17. the operator's tools (light/http_provider.py, light/proxy.py, cli.py's
     light and replay), inside phase 16's ed25519 network once its heights
     are done: (a) `python -m tendermint_tpu_torch light <chain> <node 0's
     RPC> --witnesses <node 1's>,<node 2's> --trusted-height 1
     --trusted-hash <block 1's>` with no device argument (through
     cli_counted, whose thread dumps the launch counts), its trust root's
     check and its first update (a skipping step from 1 to the tip: the 1/3
     trusting check, then the 2/3 check), launches held exactly to the keys
     each check tallies; (b) its proxy's block, commit, header and
     validators at three heights and proofs_batch and light_batch of 64
     indices of the 2,047-tx block, equal to node 0's answers (header and
     validators in the fields the proxy serves), with no launch; each
     route's median and worst ms on the proxy and on node 0; (d) SIGTERM
     ends the daemon and its session before the network stops; (c) after
     the network's teardown, `replay` (no device argument) on two copies of
     node 1's home, as it stands (no commit to check) and with its state at
     genesis (each LastCommit checked on the card): node 1's app hash,
     launches as predicted, blocks/s.

Every process the script starts goes through start_process (one-shot
commands through run_process, with a time limit and their exit code
checked) and is registered with its process group; main() runs the phases
inside a try/finally whose reap_all ends every registered group (SIGTERM,
then SIGKILL, then wait), and a SIGTERM to the script unwinds through it.
Before the last lines the audit reads /proc and fails the run, naming
each, if any process the script started is alive: a descendant, one in a
session or process group it created, or one whose command line names the
run's directory (every home and temporary directory lies under one root);
only multiprocessing's resource tracker is left out.

Phases 3, 5, 6, 7, 10, 11, 12, 13, 14, 15, 16 and 17 are each a main path: every call in them runs
with the launch counters set to 0 just before it and read just after (phase
16's node processes count from their start, and each window is the
difference of two reads of a node's /metrics; phase 17's processes count
from their start, read from the file their thread writes), and each phase fails if one
of its kernels never launched. They run at the
defaults, so through the engine (TM_TPU_ENGINE unset), but with
TM_TPU_AUTOTUNE=off, so the probe's launches, which land from a thread at
an unknown time, stay out of their counts. Phase 4's split of the valid
10,000-validator call instruments direct dispatch (TM_TPU_ENGINE=off) and
then times the same call through the engine against it.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when
there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
PLANES = ("ed25519", "sr25519")

# Published H100 SXM memory rate (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply lanes per SM per clock on Hopper.
INT32_LANES_PER_SM = 64
# Least 32-bit multiply instructions per 255-bit modular product: the 8x8
# partial products of a schoolbook multiply over 32-bit limbs (36 for a
# square), counting a 32x32->64-bit wide multiply as one instruction and
# nothing for the reduction or the additions.
MULS_PER_FE_MUL = 64
MULS_PER_FE_SQ = 36

# Field squarings (S) and multiplications (M) of each formula, counted from
# csrc/ge25519.cuh and csrc/ristretto.cuh: ZIP-215 decode 256S+19M,
# ristretto decode 256S+18M, ristretto encode 255S+21M, addition 8M (+1
# for T), doubling 4S+3M (+1 for T), cofactored equality tail 24S+22M.
DECODE = (256, 19)
RDECODE = (256, 18)
RENCODE = (255, 21)


def _ops(squares: int, mults: int) -> int:
    return squares * MULS_PER_FE_SQ + mults * MULS_PER_FE_MUL


def ops_verify(n: int) -> int:
    # 2 decodes, 14 table additions, top window add, 63 windows
    # (4 doublings + 2 additions), tail
    return n * _ops(2 * DECODE[0] + 63 * 16 + 24,
                    2 * DECODE[1] + 14 * 9 + 8 + 63 * (13 + 9 + 8) + 22)


def ops_verify_sr(n: int) -> int:
    # 2 ristretto decodes (A and R), 14 table additions, top window add, 63
    # windows (4 doublings + 2 additions), ristretto_equal's 4 products
    return n * _ops(2 * RDECODE[0] + 63 * 16,
                    2 * RDECODE[1] + 14 * 9 + 8 + 63 * (13 + 9 + 8) + 4)


def ops_pk_tables(n: int, decode=DECODE, splits: int = 4) -> int:
    # decode, S - 1 power chains of 256/S doublings (the last with T), S
    # tables of 14 additions; S = 1 is the single table
    chain = 256 // splits
    return n * _ops(decode[0] + (splits - 1) * chain * 4,
                    decode[1] + (splits - 1) * (chain * 3 + 1) + splits * 14 * 9)


def _split_ladder(splits: int) -> int:
    # 64/S steps of 4 doublings (the last with T) and 2 S additions: S comb
    # rows with T, S - 1 cache rows with T and the last without
    return (64 // splits) * (13 + splits * 9 + (splits - 1) * 9 + 8)


def ops_verify_cached(n: int, splits: int = 4) -> int:
    # decode R, the split ladder, the cofactored tail
    return n * _ops(DECODE[0] + (64 // splits) * 16 + 24, DECODE[1] + _split_ladder(splits) + 22)


def ops_verify_sr_cached(n: int, splits: int = 4) -> int:
    # the split ladder (its last addition with T), encode
    return n * _ops((64 // splits) * 16 + RENCODE[0], _split_ladder(splits) + 1 + RENCODE[1])


def ops_verify_cached_single(n: int) -> int:
    # decode R, top window add, 63 windows (4 doublings + 2 additions), tail
    return n * _ops(DECODE[0] + 63 * 16 + 24, DECODE[1] + 8 + 63 * (13 + 9 + 8) + 22)


def ops_verify_sr_cached_single(n: int) -> int:
    # ristretto decode of R, top window add, 63 windows (4 doublings + 2
    # additions), ristretto_equal's 4 products
    return n * _ops(RDECODE[0] + 63 * 16, RDECODE[1] + 8 + 63 * (13 + 9 + 8) + 4)


def ops_msm(n: int, g: int, sr: bool = False) -> int:
    dec = RDECODE if sr else DECODE
    per_row = _ops(2 * dec[0], 2 * dec[1] + 2 * 14 * 9 + 96 * 9)
    horner = _ops(63 * 16, 63 * (13 + 9))
    # the stream tree and the comb, then [zs]B added with T and one encode
    # (sr25519), or added without T and 3 doublings (ed25519)
    decide = _ops(RENCODE[0], 9 + RENCODE[1]) if sr else _ops(12, 8 + 9)
    return n * per_row + g * horner + _ops(0, (g - 1) * 9 + 64 * 9) + decide


def ops_msm_cached(n: int, g: int, splits: int) -> int:
    # per row: decode R, R's table and 96 window additions (32 of R's, 64 of
    # A's from the cache); the tail over max(32, 64/S) windows
    wn = max(32, 64 // splits)
    per_row = _ops(DECODE[0], DECODE[1] + 14 * 9 + 96 * 9)
    horner = _ops((wn - 1) * 16, (wn - 1) * (13 + 9))
    return n * per_row + g * horner + _ops(0, (g - 1) * 9 + 64 * 9) + _ops(12, 8 + 9)


def cache_read_bytes(scalar_rows, splits: int) -> int:
    """Bytes of cache entries the ladder of each row reads, once each: the
    distinct (power table, nibble) entries its scalar's 64 nibbles select,
    256 bytes an entry."""
    import numpy as np

    b = np.asarray(scalar_rows, np.uint8)
    nibs = np.stack([b & 15, b >> 4], axis=2).reshape(len(b), 64).astype(np.int64)
    ids = (np.arange(64) // (64 // splits)) * 16 + nibs if splits > 1 else nibs
    return 256 * sum(len(np.unique(row)) for row in ids)


def nvidia_smi(query: str) -> str:
    out = run_process(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"], 60,
                      "nvidia-smi").stdout
    return out.strip().splitlines()[0]


def ptxas_functions(report: str):
    """(kernel, registers, spill line) for each entry function in an
    `nvcc -Xptxas -v` report, the mangled name shortened to its identifier
    and its integer or bool template arguments."""
    out, fn, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            ident = re.match(r"_Z(\d+)(\w+)", fn)
            if ident:
                size = int(ident.group(1))
                name, rest = ident.group(2)[:size], ident.group(2)[size:]
                targs = re.match(r"I((?:L[bi]\d+E)+)E", rest)
                if targs:
                    vals = [{"b0": "false", "b1": "true"}.get(t + v, v)
                            for t, v in re.findall(r"L([bi])(\d+)E", targs.group(1))]
                    name += f"<{','.join(vals)}>"
                fn = name
            continue
        if "spill stores" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spills))
            fn, spills = None, ""
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


# -- every process the script starts: started, reaped and audited here --------

STARTED = []  # (handle, group): each Popen or multiprocessing Process, its process group if it leads one
RUN_DIRS = []  # the run's temporary root: every home and temporary directory of the run lies under it
REAP_GRACE_S = 10.0  # from SIGTERM to SIGKILL


def start_process(argv=None, *, process=None, **popen):
    """The one way the script starts a process: subprocess.Popen(argv,
    **popen), or process.start() for a multiprocessing Process. Each is
    registered, with its process group when it leads one (Popen with
    start_new_session=True), so that reap_all ends it and its group on
    every way out of main() and audit_processes can name what outlived
    it."""
    if process is not None:
        process.start()
        handle, group = process, None
    else:
        handle = subprocess.Popen(argv, **popen)
        group = handle.pid if popen.get("start_new_session") else None
    STARTED.append((handle, group))
    return handle


def run_process(argv, timeout, what, check=True, **popen):
    """A one-shot command through start_process, in a session of its own,
    to its end within `timeout` s (past it, its whole group is killed and
    `what` fails); with check, a non-zero exit fails `what`. Returns a
    CompletedProcess (stdout and stderr as text unless popen says
    otherwise)."""
    import signal

    popen = {"stdout": subprocess.PIPE, "stderr": subprocess.PIPE, "text": True, **popen}
    proc = start_process(argv, start_new_session=True, **popen)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{what}: `{' '.join(map(str, argv))}` ran past {timeout} s:\n"
                             f"{(out or '')[-3000:]}{(err or '')[-3000:]}") from None
    if check and proc.returncode:
        raise AssertionError(f"{what}: `{' '.join(map(str, argv))}` exited {proc.returncode}:\n"
                             f"{(out or '')[-2000:]}{(err or '')[-4000:]}")
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def _alive(handle) -> bool:
    return handle.poll() is None if isinstance(handle, subprocess.Popen) else handle.is_alive()


def reap_all(grace=REAP_GRACE_S) -> None:
    """End every process the script started: SIGTERM to each registered
    process group (to the process when it leads none) and to every process
    the audit finds (a grandchild in a session of its own is found while
    its parent lives, or by a command line naming the run's directory),
    SIGKILL to what is left after `grace` s, then wait for each.
    Teardown, not a fallback: it runs on every way out of main(), after a
    failure too."""
    import signal

    tracker = resource_tracker_pid()
    escaped = {pid for pid, *_ in audit_processes(exclude={tracker})}  # before any parent ends

    def signal_all(sig, pids):
        for handle, group in STARTED:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                if group is not None:
                    os.killpg(group, sig)
                elif _alive(handle):
                    os.kill(handle.pid, sig)
        for pid in pids:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, sig)

    signal_all(signal.SIGTERM, escaped)
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline and (any(_alive(h) for h, _ in STARTED)
                                           or audit_processes(exclude={tracker})):
        time.sleep(0.05)
    signal_all(signal.SIGKILL, escaped | {pid for pid, *_ in audit_processes(exclude={tracker})})
    for handle, _ in STARTED:
        with contextlib.suppress(Exception):
            if isinstance(handle, subprocess.Popen):
                handle.wait(grace)
            else:
                handle.join(grace)


def proc_table():
    """{pid: (ppid, process group, session, state, command line)} of every
    process in /proc, read and nothing else."""
    table = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue  # ended while we read
        table[int(name)] = (int(fields[1]), int(fields[2]), int(fields[3]), fields[0], cmd)
    return table


def audit_processes(exclude=()):
    """Every live process (zombies are not) that outlived its teardown: a
    descendant of this one, one in a session or process group the script
    created (STARTED), or one whose command line names a directory of
    RUN_DIRS; `exclude` left out by pid. [(pid, ppid, session, command
    line)], read from /proc alone: the audit sets nothing on the machine."""
    root = os.getpid()
    table = proc_table()
    children = {}
    for pid, (ppid, *_rest) in table.items():
        children.setdefault(ppid, []).append(pid)
    descendants, stack = set(), [root]
    while stack:
        for child in children.get(stack.pop(), ()):
            if child not in descendants:
                descendants.add(child)
                stack.append(child)
    groups = {g for _, g in STARTED if g is not None}
    found = []
    for pid, (ppid, pgrp, session, state, cmd) in sorted(table.items()):
        if pid == root or pid in exclude or state in ("Z", "X"):
            continue
        if pid in descendants or pgrp in groups or session in groups or any(d in cmd for d in RUN_DIRS):
            found.append((pid, ppid, session, cmd))
    return found


def resource_tracker_pid():
    """multiprocessing's resource tracker, which lives until this process
    ends (None if it never started)."""
    from multiprocessing import resource_tracker

    return getattr(resource_tracker._resource_tracker, "_pid", None)


def audit_or_fail() -> None:
    """The audit before the last lines: every process it finds is printed
    (pid, ppid, session, command line) and killed, and the run fails."""
    import signal

    found = audit_processes(exclude={resource_tracker_pid()})
    for pid, ppid, session, cmd in found:
        log(f"audit: process {pid} (ppid {ppid}, session {session}) outlived its teardown: {cmd[:400]}")
    for pid, *_ in found:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.kill(pid, signal.SIGKILL)
    if found:
        raise AssertionError(f"audit: {len(found)} process(es) that the script started are still alive")
    log(f"audit: no process that the script started is alive ({len(STARTED)} started, the resource tracker "
        f"left out)")


# -- the two signature planes -------------------------------------------------


def plane(kind: str) -> SimpleNamespace:
    """One signature plane's host pieces, kernels, plain versions and
    bound model, under shared names."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.ops import verify_sr as VS

    if kind == "ed25519":
        return SimpleNamespace(
            kind=kind, prepare=V.prepare_batch, oracle=ref.verify, cache=V.pubkey_cache,
            edges=edge_batch, batch=V.verify_batch,
            bitmap=V.verify_kernel, bitmap_plain=V.verify_kernel_plain, bitmap_steps=BITMAP_STEPS,
            fill=V.build_pk_tables_split, fill_plain=V.build_pk_tables_split_plain,
            hit=V.verify_kernel_cached_split, hit_plain=V.verify_kernel_cached_split_plain,
            fill1=V.build_pk_tables, fill1_plain=V.build_pk_tables_plain,
            hit1=V.verify_kernel_cached, hit1_plain=V.verify_kernel_cached_plain,
            rlc=M.msm_verify_kernel, rlc_plain=M.msm_verify_kernel_plain,
            ops_bitmap=ops_verify, ops_fill=lambda n, s: ops_pk_tables(n, DECODE, s),
            ops_hit=lambda n, s: ops_verify_cached_single(n) if s == 1 else ops_verify_cached(n, s),
            ops_rlc=lambda n, g: ops_msm(n, g),
        )
    return SimpleNamespace(
        kind=kind, prepare=VS.prepare_batch, oracle=sr.verify, cache=VS.sr_pubkey_cache,
        edges=sr_edge_batch, batch=VS.verify_batch,
        bitmap=VS.verify_sr_kernel, bitmap_plain=VS.verify_sr_kernel_plain,
        bitmap_steps=SR_BITMAP_STEPS,
        fill=VS.build_sr_tables_split, fill_plain=VS.build_sr_tables_split_plain,
        hit=VS.verify_sr_kernel_cached_split, hit_plain=VS.verify_sr_kernel_cached_split_plain,
        fill1=VS.build_sr_tables, fill1_plain=VS.build_sr_tables_plain,
        hit1=VS.verify_sr_kernel_cached, hit1_plain=VS.verify_sr_kernel_cached_plain,
        rlc=M.msm_verify_sr_kernel, rlc_plain=M.msm_verify_sr_kernel_plain,
        ops_bitmap=ops_verify_sr, ops_fill=lambda n, s: ops_pk_tables(n, RDECODE, s),
        ops_hit=lambda n, s: ops_verify_sr_cached_single(n) if s == 1 else ops_verify_sr_cached(n, s),
        ops_rlc=lambda n, g: ops_msm(n, g, sr=True),
    )


def cache_pair(P, splits: int):
    """(fill, fill_plain, hit, hit_plain) of a plane at a split, each taking
    what the main path hands it: the single-table kernels at S = 1, the
    split ones (the fill told S, the hit reading it from the tables) above."""
    if splits == 1:
        return P.fill1, P.fill1_plain, P.hit1, P.hit1_plain
    return (lambda a: P.fill(a, splits)), (lambda a: P.fill_plain(a, splits)), P.hit, P.hit_plain


# kernel -> (its source, the JAX program it replaces)
KERNEL_SOURCES = {
    "verify_kernel": ("csrc/verify.cu", "tendermint_tpu/ops/verify.py:81"),
    "build_pk_tables_split": ("csrc/pk_tables.cu", "tendermint_tpu/ops/verify.py:141"),
    "verify_kernel_cached_split": ("csrc/verify_cached.cu", "tendermint_tpu/ops/verify.py:157"),
    "msm_verify_kernel": ("csrc/msm.cu", "tendermint_tpu/ops/msm.py:162"),
    "verify_sr_kernel": ("csrc/verify_sr.cu", "tendermint_tpu/ops/verify_sr.py:46"),
    "build_sr_tables_split": ("csrc/sr_tables.cu", "tendermint_tpu/ops/verify_sr.py:89"),
    "verify_sr_kernel_cached_split": ("csrc/verify_sr_cached.cu", "tendermint_tpu/ops/verify_sr.py:112"),
    "msm_verify_sr_kernel": ("csrc/msm_sr.cu", "tendermint_tpu/ops/msm.py:272"),
    "build_pk_tables": ("csrc/pk_tables_single.cu", "tendermint_tpu/ops/verify.py:95"),
    "verify_kernel_cached": ("csrc/verify_cached_single.cu", "tendermint_tpu/ops/verify.py:113"),
    "msm_verify_kernel_cached": ("csrc/msm_cached.cu", "tendermint_tpu/ops/msm.py:241"),
    "build_sr_tables": ("csrc/sr_tables_single.cu", "tendermint_tpu/ops/verify_sr.py:59"),
    "verify_sr_kernel_cached": ("csrc/verify_sr_cached_single.cu", "tendermint_tpu/ops/verify_sr.py:75"),
    "fail_count": ("csrc/fail_count.cu", "tendermint_tpu/parallel/sharded_verify.py:46"),
}
# The pubkey-cache geometries (TM_TPU_PK_SPLIT): the default and the others.
DEFAULT_SPLITS = 4
OTHER_SPLITS = (1, 2, 8)
RLC_CACHE_SPLITS = (2, 4, 8)


# -- keys and signatures (set-up, not timed) ---------------------------------


def _sign_worker(job):
    kind, seed, msgs = job
    if kind == "sr25519":
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey

        priv = Sr25519PrivKey(seed)
        return priv.pub_key().bytes(), [priv.sign(m) for m in msgs]
    if kind == "secp256k1":
        from tendermint_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey

        priv = Secp256k1PrivKey.generate(seed)
        return priv.pub_key().bytes(), [priv.sign(m) for m in msgs]
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

        key = Ed25519PrivateKey.from_private_bytes(seed)
        pub = key.public_key().public_bytes(serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        return pub, [key.sign(m) for m in msgs]
    except ImportError:
        from tendermint_tpu_torch.crypto import ed25519_ref as ref

        priv = ref.gen_privkey(seed)
        return priv[32:], [ref.sign(priv, m) for m in msgs]


def make_keys(pool, kind, seeds):
    return [pub for pub, _ in pool.map(_sign_worker, [(kind, s, []) for s in seeds], chunksize=64)]


def sign_all(pool, kind, seeds, msg_lists):
    jobs = [(kind, s, m) for s, m in zip(seeds, msg_lists)]
    return [sigs for _, sigs in pool.map(_sign_worker, jobs, chunksize=64)]


def build_commit(pool, kind, seeds, pubs, rng, n, chain_id, height):
    """A commit of n validators of equal power, every one voting for the
    block, signed over the canonical vote sign bytes."""
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
    from tendermint_tpu_torch.utils.tmtime import Time

    key = Sr25519PubKey if kind == "sr25519" else Ed25519PubKey
    vals = ValidatorSet.new([Validator.new(key(pubs[i]), 10) for i in range(n)])
    seed_of = {key(pubs[i]).address(): seeds[i] for i in range(n)}
    block_id = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    commit = Commit(height=height, round=0, block_id=block_id, signatures=[
        CommitSig.new_commit(v.address, Time(1_700_000_000 + i, 1000 * i + 7), b"")
        for i, v in enumerate(vals.validators)
    ])
    msgs = [commit.vote_sign_bytes(chain_id, i) for i in range(n)]
    order = [seed_of[v.address] for v in vals.validators]
    for cs, sigs in zip(commit.signatures, sign_all(pool, kind, order, [[m] for m in msgs])):
        cs.signature = sigs[0]
    return vals, block_id, commit


def tamper(sig: bytes) -> bytes:
    return sig[:40] + bytes([sig[40] ^ 0x01]) + sig[41:]


# -- phase 2: kernels against their plain versions ---------------------------


def sign_torsion_r(priv: bytes, msg: bytes, rng) -> bytes:
    """An ed25519 signature whose R is [r]B plus a point of order 8, the
    challenge taken over that R: valid under the cofactored equation only."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    t8 = next(p for p in map(ref.decompress, ref.small_order_points())
              if not ref.point_is_identity(ref.scalar_mult(4, p)))
    a = ref._clamp(ref._sha512(priv[:32]))
    r = int.from_bytes(rng.bytes(64), "little") % ref.L
    r_enc = ref.compress(ref.point_add(ref.scalar_mult(r, ref.BASE), t8))
    s = (r + ref.challenge_scalar(r_enc, priv[32:], msg) * a) % ref.L
    return r_enc + s.to_bytes(32, "little")


def edge_batch(rng, n=64):
    """n rows: honest signatures, tampered ones, and the ZIP-215 edges."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    pks, msgs, sigs = [], [], []
    for i in range(n - 9):
        priv = ref.gen_privkey(rng.bytes(32))
        msg = b"chip-smoke-%d" % i + rng.bytes(16)
        sig = ref.sign(priv, msg)
        if i % 9 == 4:
            sig = tamper(sig)
        pks.append(priv[32:])
        msgs.append(msg)
        sigs.append(sig)
    so = ref.small_order_points()
    ident = ref.compress(ref.IDENTITY)
    # small-order key, identity R, s = 0: valid under the cofactored equation
    pks.append(so[1]); msgs.append(b"anything"); sigs.append(ident + b"\x00" * 32)
    # s + L: fails the host precheck
    s = int.from_bytes(sigs[0][32:], "little")
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(sigs[0][:32] + (s + ref.L).to_bytes(32, "little"))
    # a non-point key
    y = 2
    while ref.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    pks.append(y.to_bytes(32, "little")); msgs.append(b"x"); sigs.append(sigs[0])
    # y >= p (y = p + 1 decodes as y = 1), and x = 0 with the sign bit set
    pks.append((ref.P + 1).to_bytes(32, "little")); msgs.append(b"y>=p"); sigs.append(ident + b"\x00" * 32)
    neg_zero = bytearray(ident); neg_zero[31] |= 0x80
    pks.append(bytes(neg_zero)); msgs.append(b"-0"); sigs.append(bytes(neg_zero) + b"\x00" * 32)
    # a small-order R on an honest key
    priv = ref.gen_privkey(rng.bytes(32))
    pks.append(priv[32:]); msgs.append(b"so-R"); sigs.append(so[2] + ref.sign(priv, b"so-R")[32:])
    # an R that does not decode, on the same key
    pks.append(priv[32:]); msgs.append(b"bad-R"); sigs.append(y.to_bytes(32, "little") + ref.sign(priv, b"bad-R")[32:])
    # a non-canonical R (y = p + 1, the identity) over a small-order key, s = 0: valid
    pks.append(so[1]); msgs.append(b"R>=p"); sigs.append((ref.P + 1).to_bytes(32, "little") + b"\x00" * 32)
    # R = [r]B + a point of order 8: valid after the cofactor
    pks.append(priv[32:]); msgs.append(b"R+T8"); sigs.append(sign_torsion_r(priv, b"R+T8", rng))
    return pks, msgs, sigs


# RFC 9496 appendix A.2: encodings every ristretto255 decoder rejects
# (non-canonical s, negative s, non-square x^2, negative xy, s = -1).
RISTRETTO_BAD_ENCODINGS = [
    "00ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "f3ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "0100000000000000000000000000000000000000000000000000000000000000",
    "01ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "ed57ffd8c914fb201471d1c3d245ce3c746fcbe63a3679d51b6a516ebebe0e20",
    "26948d35ca62e643e26a83177332e6b6afeb9d08e4268b650f1f5bbd8d81d371",
    "4eac077a713c57b4f4397629a4145982c661f48044dd3f96427d40b147d9742f",
    "3eb858e78f5a7254d8c9731174a94f76755fd3941c0ac93735c07ba14579630e",
    "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a",
]


def sr_edge_batch(rng, n=64):
    """n rows: honest sr25519 signatures, tampered s and tampered R, the RFC
    9496 bad encodings as keys, a missing marker bit, s >= L, an honest R
    made non-canonical (s + p), negated and replaced by random bytes, and
    the zero row (identity key, identity R, s = 0: valid)."""
    from tendermint_tpu_torch.crypto import sr25519 as sr

    pks, msgs, sigs = [], [], []
    for i in range(n - len(RISTRETTO_BAD_ENCODINGS) - 7):
        priv = sr.Sr25519PrivKey(rng.bytes(32))
        msg = b"chip-smoke-sr-%d" % i + rng.bytes(16)
        sig = priv.sign(msg)
        if i % 9 == 4:
            sig = tamper(sig)
        elif i % 9 == 7:
            sig = bytes([sig[0] ^ 0x04]) + sig[1:]  # R
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(sig)
    for enc in RISTRETTO_BAD_ENCODINGS:
        pks.append(bytes.fromhex(enc)); msgs.append(msgs[0]); sigs.append(sigs[0])
    # a bad R encoding on an honest key
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(bytes.fromhex(RISTRETTO_BAD_ENCODINGS[7]) + sigs[0][32:])
    # the marker bit cleared
    nomark = bytearray(sigs[0]); nomark[63] &= 0x7F
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(bytes(nomark))
    # s + L with the marker bit: fails the host precheck
    s = int.from_bytes(sigs[0][32:], "little") & ((1 << 255) - 1)
    big = bytearray((s + sr.L).to_bytes(32, "little")); big[31] |= 0x80
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(sigs[0][:32] + bytes(big))
    # row 1's honest R non-canonical (s + p), negated, and random bytes
    r_enc, rest = sigs[1][:32], sigs[1][32:]
    neg_r = sr.ristretto_encode(sr.point_neg(sr.ristretto_decode(r_enc)))
    for r_bad in ((int.from_bytes(r_enc, "little") + sr.P).to_bytes(32, "little"), neg_r, rng.bytes(32)):
        pks.append(pks[1]); msgs.append(msgs[1]); sigs.append(r_bad + rest)
    # the zero row, marked
    pks.append(bytes(32)); msgs.append(b"zero"); sigs.append(bytes(63) + b"\x80")
    return pks, msgs, sigs


def canonical_tables(t):
    """Cache tables with every coordinate made canonical (limb axis first
    for fe_canonical, and back)."""
    import torch

    from tendermint_tpu_torch.ops import field as F

    return F.fe_canonical(t.to(torch.int32).movedim(-1, 0)).movedim(0, -1)


def kernel_label(fn, splits: int) -> str:
    """A kernel's name in the record: the wrapper's, with the split for a
    wrapper that serves several (S = 2 and 8; S = 4 is the default)."""
    return fn.__name__ if splits in (None, 1, DEFAULT_SPLITS) else f"{fn.__name__}[S={splits}]"


def check_fill(name, tabs, oks, ptabs, poks, all_decode: bool = False) -> int:
    """A fill against its plain version: equal tables after fe_canonical,
    equal decode bits, and canonical coordinates from the kernel; returns
    the max |error|."""
    import torch

    err = int((canonical_tables(tabs) - canonical_tables(ptabs)).abs().max())
    if err or not torch.equal(oks, poks) or (all_decode and not bool(oks.all())):
        raise AssertionError(f"{name}: max |kernel - plain| after fe_canonical = {err}, "
                             f"{int((oks != poks).sum())} decode bits differ")
    if tabs.is_cuda and not torch.equal(tabs.to(torch.int32), canonical_tables(tabs)):
        raise AssertionError(f"{name}: the kernel wrote non-canonical coordinates")
    return err


def check_kernels(rng, dev, P):
    """One plane's four kernels against their plain versions and its oracle
    on the plane's edge batch; returns each kernel's max |error|."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    def cuda(*arrays):
        return V._to_device(list(arrays), dev)

    errs = {}
    pks, msgs, sigs = P.edges(rng)
    n = len(sigs)
    a, r, s, k, pre = P.prepare(pks, msgs, sigs)
    a_d, r_d, s_d, k_d = cuda(a, r, s, k)
    name = P.bitmap.__name__

    got = P.bitmap(a_d, r_d, s_d, k_d)
    want = P.bitmap_plain(a_d, r_d, s_d, k_d)
    torch.cuda.synchronize()
    oracle = np.array([P.oracle(p, m, g) for p, m, g in zip(pks, msgs, sigs)])
    bitmap = got.cpu().numpy() & pre
    if not torch.equal(got, want) or not (bitmap == oracle).all():
        raise AssertionError(f"{name}: kernel {got.tolist()} plain {want.tolist()} "
                             f"oracle {oracle.tolist()}")
    errs[name] = 0
    log(f"phase 2: {name} == plain == oracle on {n} rows ({int(oracle.sum())} valid)")
    if P.kind == "sr25519":
        # an honest row's R made odd (p - R) and non-canonical (R + p) after
        # the host prep, so k stays R's: decode rejects both, and the odd
        # encoding's decode candidate is R's point, so only R's decode bit
        # makes that row false
        from tendermint_tpu_torch.crypto import sr25519 as sr

        h = int(np.flatnonzero(oracle)[0])
        r_int = int.from_bytes(r[h].tobytes(), "little")
        bad_r = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in (sr.P - r_int, r_int + sr.P)),
                              np.uint8).reshape(2, 32)
        rows = cuda(a[[h, h]], bad_r, s[[h, h]], k[[h, h]])
        got, want = P.bitmap(*rows), P.bitmap_plain(*rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or bool(got.any()):
            raise AssertionError(f"{name} on R made odd and non-canonical: kernel {got.tolist()} "
                                 f"plain {want.tolist()}")
        log(f"phase 2: {name} == plain == False on an honest row with R made odd and non-canonical")

    caches = {}
    for splits in (DEFAULT_SPLITS,) + OTHER_SPLITS:
        fill, fill_plain, hit, hit_plain = cache_pair(P, splits)
        name = kernel_label(P.fill1 if splits == 1 else P.fill, splits)
        tabs, oks = fill(a_d)
        ptabs, poks = fill_plain(a_d)
        torch.cuda.synchronize()
        errs[name] = check_fill(name, tabs, oks, ptabs, poks)
        log(f"phase 2: {name} == canonical(plain) on {n} keys, {tabs.numel() // 32} coordinates "
            f"({int(oks.sum())} decode)")

        name = kernel_label(P.hit1 if splits == 1 else P.hit, splits)
        perm = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)
        cache_t = torch.empty_like(tabs).index_copy_(0, perm, tabs)
        cache_o = torch.empty_like(oks).index_copy_(0, perm, oks)
        slots = perm.to(torch.int32)
        got = hit(cache_t, cache_o, slots, r_d, s_d, k_d)
        want = hit_plain(cache_t, cache_o, slots, r_d, s_d, k_d)
        # the plain fill's signed limbs through the kernel (the carried-across cache)
        plain_cache = torch.empty_like(ptabs).index_copy_(0, perm, ptabs)
        got_signed = hit(plain_cache, cache_o, slots, r_d, s_d, k_d)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, got_signed)) or not (
                (got.cpu().numpy() & pre) == oracle).all():
            raise AssertionError(f"{name}: kernel {got.tolist()} plain {want.tolist()}")
        _, _, rows = hit_edges(hit, hit_plain, oracle, cache_t, cache_o, slots, r_d, s_d, k_d)
        if P.kind == "sr25519":
            # the hits decide by R's decode bit too: the odd and non-canonical R above
            got = hit(cache_t, cache_o, slots[[h, h]], *cuda(bad_r, s[[h, h]], k[[h, h]]))
            want = hit_plain(cache_t, cache_o, slots[[h, h]], *cuda(bad_r, s[[h, h]], k[[h, h]]))
            torch.cuda.synchronize()
            if not torch.equal(got, want) or bool(got.any()):
                raise AssertionError(f"{name} on R made odd and non-canonical: kernel {got.tolist()} "
                                     f"plain {want.tolist()}")
        errs[name] = 0
        log(f"phase 2: {name} == plain == oracle on {n} rows (both table forms); == plain with a "
            f"tampered k, oks false and slots - C wrapped at valid rows {rows}, and slots "
            f"{edge_slots(len(cache_t))}" + (", and == plain == False with R made odd and non-canonical"
                                             if P.kind == "sr25519" else ""))
        caches[splits] = cache_t, cache_o, slots

    name = P.rlc.__name__
    keep = [i for i in range(n) if oracle[i]]
    bad = next(i for i in range(n) if pre[i] and not oracle[i])  # a tampered row
    for label, idx in (("valid", keep), ("tampered", keep[:-1] + [bad])):
        bp, bm, bs = [pks[i] for i in idx], [msgs[i] for i in idx], [sigs[i] for i in idx]
        a2, r2, s2, k2, pre2 = P.prepare(bp, bm, bs)
        z_raw = rng.bytes(16 * len(idx))
        zk, z, zs = M._rlc_scalars(s2, k2, len(idx), z_raw)
        rows = cuda(*V.pad_pow2_rows([a2, r2, zk, z], len(idx)), zs)
        got = P.rlc(*rows)
        want = P.rlc_plain(*rows)
        torch.cuda.synchronize()
        expect = label == "valid"
        if bool(got) != bool(want) or bool(got) != expect:
            raise AssertionError(f"{name} ({label}): kernel {bool(got)} plain {bool(want)}")
        log(f"phase 2: {name} == plain == {expect} on a {label} batch of {len(idx)} rows")
    errs[name] = 0
    if P.kind == "ed25519":
        check_rlc_cached(rng, dev, P, caches, pks, msgs, sigs, oracle, pre, errs)
    return errs


# Slots no real path hands out, held as the reference's jnp gather maps
# them (a negative slot counts from the end, then the index clamps):
# -1, -5, -C, -C - 1, INT32_MIN, C, C + 3 and INT32_MAX.
def edge_slots(cap: int):
    return [-1, -5, -cap, -cap - 1, -2**31, cap, cap + 3, 2**31 - 1]


def hit_edges(hit, hit_plain, oracle, cache_t, cache_o, slots, r, s, k):
    """A cache hit on the cache's own edges: a tampered k and a slot whose
    oks is false, each at a valid row; four valid rows whose slots are
    given counted from the end (slot - C, which must wrap back to the
    key's own entry and stay valid); and the edge_slots at other rows. The
    plain version gets the same raw slots. The kernel must equal it,
    reject the tampered and the oks-false rows and accept the wrapped
    ones."""
    import torch

    valid = [i for i in range(len(oracle)) if oracle[i]]
    ka, od, *wrapped = valid[:6]
    cap = len(cache_t)
    edges = [i for i in range(len(oracle)) if i not in valid[:6]][:len(edge_slots(cap))]
    k_x = k.clone()
    k_x[ka, 3] ^= 0x20
    slots_x = slots.clone()
    for i in wrapped:
        slots_x[i] -= cap
    for i, v in zip(edges, edge_slots(cap)):
        slots_x[i] = v
    oks_x = cache_o.clone()
    oks_x[slots[od].long()] = False
    got = hit(cache_t, oks_x, slots_x, r, s, k_x)
    want = hit_plain(cache_t, oks_x, slots_x, r, s, k_x)
    torch.cuda.synchronize()
    if (not torch.equal(got, want) or bool(got[ka]) or bool(got[od])
            or not all(bool(got[i]) for i in wrapped)):
        raise AssertionError(f"{hit.__name__} on the cache edges (tampered k #{ka}, oks false #{od}, "
                             f"slots - C at {wrapped}, edge slots at {edges}): kernel {got.tolist()} "
                             f"plain {want.tolist()}")
    return got, want, (ka, od, *wrapped)


def check_rlc_cached(rng, dev, P, caches, pks, msgs, sigs, oracle, pre, errs):
    """The cached RLC (kernel 7) against its plain version on the edge
    batch's valid rows and on them with one tampered row, through the edge
    caches of every split it takes."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    n = len(sigs)
    keep = [i for i in range(n) if oracle[i]]
    bad = next(i for i in range(n) if pre[i] and not oracle[i])
    for splits in RLC_CACHE_SPLITS:
        cache_t, cache_o, slots = caches[splits]
        name = kernel_label(M.msm_verify_kernel_cached, splits)
        for verdict, idx in (("valid", keep), ("tampered", keep[:-1] + [bad])):
            _, r2, s2, k2, _ = P.prepare([pks[i] for i in idx], [msgs[i] for i in idx],
                                         [sigs[i] for i in idx])
            zk, z, zs = M._rlc_scalars(s2, k2, len(idx), rng.bytes(16 * len(idx)))
            r2, zk, z = V.pad_pow2_rows([r2, zk, z], len(idx))
            sl = slots[torch.tensor(idx + [idx[-1]] * (len(r2) - len(idx)), device=dev)]
            rows = V._to_device([r2, zk, z, zs], dev)
            got = M.msm_verify_kernel_cached(cache_t, cache_o, sl, *rows)
            want = M.msm_verify_kernel_cached_plain(cache_t, cache_o, sl, *rows)
            torch.cuda.synchronize()
            if bool(got) != bool(want) or bool(got) != (verdict == "valid"):
                raise AssertionError(f"{name} ({verdict}): kernel {bool(got)} plain {bool(want)}")
            log(f"phase 2: {name} == plain == {verdict == 'valid'} on a {verdict} batch of "
                f"{len(idx)} rows")
        errs[name] = 0


# -- phase 3: the main path ---------------------------------------------------


def kernel_wrappers():
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.ops import verify_sr as VS
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    return (V.verify_kernel, V.build_pk_tables_split, V.verify_kernel_cached_split,
            M.msm_verify_kernel, VS.verify_sr_kernel, VS.build_sr_tables_split,
            VS.verify_sr_kernel_cached_split, M.msm_verify_sr_kernel, V.build_pk_tables,
            V.verify_kernel_cached, M.msm_verify_kernel_cached, VS.build_sr_tables,
            VS.verify_sr_kernel_cached, SV.fail_count)


def sharded_entries():
    """The sharded entry points, by the reference's sharded_launches label."""
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    return {"bitmap": SV.verify_batch_sharded, "cached": SV.verify_batch_sharded_cached,
            "rlc": SV.verify_batch_sharded_rlc}


def reset_counts():
    for fn in kernel_wrappers() + tuple(sharded_entries().values()):
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def expect_wrong_signature(fn, idx):
    try:
        fn()
    except ValueError as e:
        if not str(e).startswith(f"wrong signature (#{idx}):"):
            raise AssertionError(f"tampered commit raised the wrong error: {e}") from e
        return str(e)
    raise AssertionError(f"tampered signature #{idx} was accepted")


def drive(what, fn, want, totals, entries=None, rows=None, merge=None):
    """One main-path call with every launch counter set to 0 just before it
    and read just after; fails unless it made exactly the launches `want`
    names (and, where `entries` is given, took exactly those sharded entry
    points). Where `rows` is (counter of rlc_rows(), plane, n), the call
    must also carry exactly n RLC rows of that plane. Where `merge` names an
    RLC kernel, the engine may have merged the call's checks: the same
    launches with fewer (but some) of that kernel pass, and are logged.
    Adds them to `totals`; returns (output, wall seconds)."""
    r0 = rows[0].get(rows[1], 0) if rows else 0
    reset_counts()
    out, t = timed(fn)
    got = {name: c for name, c in read_counts().items() if c}
    merged = (merge is not None and got != want and set(got) == set(want) and 0 < got[merge] < want[merge]
              and all(got[k] == want[k] for k in want if k != merge))
    carried = rows[0].get(rows[1], 0) - r0 if rows else None
    if (got != want and not merged) or (rows and carried != rows[2]):
        raise AssertionError(f"{what} launched {got}" + (f" on {carried} RLC rows" if rows else "")
                             + f", expected {want}" + (f" on {rows[2]}" if rows else ""))
    if merged:
        log(f"{what}: the engine merged checks: {got[merge]} RLC launches carried {carried} rows, "
            f"{want[merge]} expected")
    took = {label: entry.launches for label, entry in sharded_entries().items() if entry.launches}
    if entries is not None and took != entries:
        raise AssertionError(f"{what} took the sharded entries {took}, expected {entries}")
    for name, c in got.items():
        totals[name] = totals.get(name, 0) + c
    return out, t


def check_path(what, totals, expected):
    """Fail if a kernel of a path's expected launches never ran in it."""
    idle = sorted({name for want in expected for name in want} - set(totals))
    if idle:
        raise AssertionError(f"{what} never launched {idle}")
    log(f"{what}: launches {json.dumps(totals)}")


def _expected(bitmap, fill, hit, rlc):
    """The launches each main-path call of one plane must make. Each plane
    has its own pubkey cache, which starts empty, and the 150 validators'
    keys are among the 1,000's: a valid commit of 256 or more signatures
    runs the RLC alone; a tampered one then runs the bitmap plane, through
    the cache (fill, then hit) up to 4,096 distinct keys and uncached
    beyond; the 150-validator commit goes straight to the cached bitmap,
    and the trusting check stops at 51 signatures, below the 64-signature
    cutover, so it runs on the host."""
    small, mid, large = SIZES
    return {
        (small, "valid"): {fill: 1, hit: 1},
        (small, "trusting"): {},
        (mid, "valid"): {rlc: 1},
        (mid, "tampered"): {rlc: 1, fill: 1, hit: 1},
        (large, "valid"): {rlc: 1},
        (large, "tampered"): {rlc: 1, bitmap: 1},
    }


SIZES = (150, 1000, 10000)
EXPECTED_LAUNCHES = {
    "ed25519": _expected("verify_kernel", "build_pk_tables_split", "verify_kernel_cached_split",
                         "msm_verify_kernel"),
    "sr25519": _expected("verify_sr_kernel", "build_sr_tables_split",
                         "verify_sr_kernel_cached_split", "msm_verify_sr_kernel"),
}


def main_commits(pool, rng, keys, chain_id):
    """Phase 3's commits on each plane, at every size, signed on the pool."""
    commits = {}
    for kind in PLANES:
        t0 = time.perf_counter()
        seeds, pubs = keys[kind]
        commits[kind] = {n: build_commit(pool, kind, seeds, pubs, rng, n, chain_id, 100 + n)
                         for n in SIZES}
        log(f"phase 3: {kind} commits signed in {time.perf_counter() - t0:.1f} s")
    return commits


def main_path(commits, chain_id):
    """verify_commit on each plane's commits, with every launch counter set
    to 0 just before each call and read just after; returns the tampered
    index of each commit, the summed launches and the wall times."""
    from tendermint_tpu_torch.types.validation import (
        Fraction, verify_commit, verify_commit_light_trusting,
    )

    bad_index = {n: (n * 5) // 12 for n in SIZES}
    totals = {}
    runs = []

    def run(kind, n, label, fn):
        return drive(f"{kind} {label} call on {n} validators", fn,
                     EXPECTED_LAUNCHES[kind][n, label], totals)

    for kind in PLANES:
        for n, (vals, bid, commit) in commits[kind].items():
            _, t = run(kind, n, "valid", lambda: verify_commit(chain_id, vals, bid, commit.height, commit))
            runs.append({"plane": kind, "commit": n, "run": "verify_commit valid", "s": t,
                         "sigs_per_s": n / t})
            if n == SIZES[0]:
                _, t = run(kind, n, "trusting", lambda: verify_commit_light_trusting(
                    chain_id, vals, commit, Fraction(1, 3)))
                runs.append({"plane": kind, "commit": n, "run": "verify_commit_light_trusting 1/3",
                             "s": t})
                continue
            msg, t = verify_tampered(chain_id, commits[kind][n], bad_index[n], lambda fn: run(
                kind, n, "tampered", fn))
            runs.append({"plane": kind, "commit": n, "run": f"verify_commit tampered #{bad_index[n]}",
                         "s": t, "sigs_per_s": n / t, "error": msg[:40]})
    for r in runs:
        log("phase 3: " + json.dumps(r))
    check_path("phase 3", totals, [w for kind in PLANES for w in EXPECTED_LAUNCHES[kind].values()])
    return bad_index, totals, runs


def verify_tampered(chain_id, commit_entry, bad, run):
    """verify_commit on the commit with signature #bad tampered, through
    run(fn), which must report it at its index; the commit is restored."""
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, bid, commit = commit_entry
    good = commit.signatures[bad].signature
    commit.signatures[bad].signature = tamper(good)
    try:
        return run(lambda: expect_wrong_signature(
            lambda: verify_commit(chain_id, vals, bid, commit.height, commit), bad))
    finally:
        commit.signatures[bad].signature = good


# -- phase 4: kernels at the main path's shapes, and times --------------------


def event_ms(fn, reps: int):
    """(first output, mean ms of reps launches after two warm-up launches)."""
    import torch

    out = fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def plain_ms(fn, warm: bool = True):
    """(output, ms) of one timed run, after one warm run unless the caller
    has just run the same shapes (the plain versions take seconds)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# The launches of kernels 4 and 8 by kernel name (the earlier, three-launch
# design has no reduce).
RLC_STEPS = ("msm_tables", "msm_windows", "msm_reduce", "msm_tail")
# The launches of kernels 1 and 9: the decode step, then the four-lane ladder.
BITMAP_STEPS = ("verify_tables", "verify_ladder")
SR_BITMAP_STEPS = ("verify_sr_tables", "verify_sr_ladder")


def step_times(fn, reps: int = 5, names=RLC_STEPS):
    """Device ms a call of each step (the RLC's by default), by kernel
    name, from torch.profiler over reps calls after one warm-up call; {}
    when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    steps = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        name = evt.key.split("(")[0]
        for step in names:
            if us and re.search(rf"\b{step}\b", name):
                steps[step] = steps.get(step, 0.0) + us / 1e3 / reps
    return steps


def bound_ms(ops: int, nbytes: int, int32_rate: float):
    t_ops = ops / int32_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def commit_jobs(commit_entry, chain_id, bad=None):
    """The (pubkeys, messages, signatures) verify_commit hands the batch
    verifier, with signature #bad tampered when bad is given."""
    vals, _, commit = commit_entry
    sigs = [cs.signature for cs in commit.signatures]
    if bad is not None:
        sigs[bad] = tamper(sigs[bad])
    return ([v.pub_key.bytes() for v in vals.validators],
            [commit.vote_sign_bytes(chain_id, i) for i in range(len(sigs))], sigs)


@contextlib.contextmanager
def native_setting(python: bool):
    """TM_TPU_NATIVE=0 (the Python host prep) inside the block when python
    is true, unset (the native C) otherwise; restored after."""
    before = os.environ.pop("TM_TPU_NATIVE", None)
    if python:
        os.environ["TM_TPU_NATIVE"] = "0"
    try:
        yield
    finally:
        os.environ.pop("TM_TPU_NATIVE", None)
        if before is not None:
            os.environ["TM_TPU_NATIVE"] = before


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return run_process(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], 60,
                       "nvidia-smi").stdout.strip().splitlines()[0]


HOST_PREP_TURNS = ("python", "native", "native", "python")


def host_prep_route(P, jobs, n, z_raw, python: bool):
    """One plane's host prep of a commit on one route, timed by part:
    prepare_batch and the RLC scalars; on the Python route also the
    challenges alone (a separate call), on the native one (ed25519) the
    C call alone, on buffers joined before it (challenges, s < L and
    shaping, threaded)."""
    import ctypes
    import hashlib

    import numpy as np

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import msm as M

    pks, msgs, sigs = jobs
    split = {}
    with native_setting(python):
        if python:
            t0 = time.perf_counter()
            if P.kind == "sr25519":
                sr.challenges_batch(pks, msgs, [g[:32] for g in sigs])
            else:
                for p, m, g in zip(pks, msgs, sigs):
                    hashlib.sha512(g[:32] + p + m).digest()
            split["challenges_s"] = time.perf_counter() - t0
        elif P.kind == "ed25519":
            lib = native.load_prep()
            blobs = [b"".join(x) for x in jobs]
            offsets = native.offsets_of(msgs)
            rows = np.zeros((4, n, 32), np.uint8)
            pre = np.zeros(n, np.uint8)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            t0 = time.perf_counter()
            rc = lib.prepare_batch(*blobs, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                                   *(x.ctypes.data_as(u8p) for x in rows), pre.ctypes.data_as(ctypes.c_char_p))
            split["c_prepare_s"] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"native prepare_batch returned {rc}")
        t0 = time.perf_counter()
        a, r, s_rows, k_rows, pre = P.prepare(*jobs)
        t1 = time.perf_counter()
        zk, z, zs = M._rlc_scalars(s_rows, k_rows, n, z_raw)
        t2 = time.perf_counter()
    split.update(prepare_batch_s=t1 - t0, rlc_scalars_s=t2 - t1)
    return (a, r, s_rows, k_rows, pre, zk, z, zs), split


def host_prep(P, jobs, n, z_raw, timed_turns: bool):
    """One plane's host prep of a commit on both routes, the native C and
    the Python that TM_TPU_NATIVE=0 selects, which must give the same rows,
    precheck and scalars byte for byte. With timed_turns, in turns
    HOST_PREP_TURNS, the mean of each route's turns by part; else one turn
    each. Returns the native route's (a, r, zk, z, zs, pre) and the split."""
    import numpy as np

    outs, turns = {}, {"python": [], "native": []}
    for route in HOST_PREP_TURNS if timed_turns else ("python", "native"):
        out, split = host_prep_route(P, jobs, n, z_raw, route == "python")
        turns[route].append(split)
        outs.setdefault(route, out)
    names = ("a", "r", "s", "k", "precheck", "zk", "z", "zs")
    diff = [name for name, x, y in zip(names, outs["python"], outs["native"])
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y)]
    if diff:
        raise AssertionError(f"{P.kind} host prep of {n} rows: the native route differs from the Python "
                             f"route in {diff}")
    split = {}
    for route, splits in turns.items():
        for key in splits[0]:
            split[f"{route}_{key}"] = sum(sp[key] for sp in splits) / len(splits)
    a, r, _, _, pre, zk, z, zs = outs["native"]
    return (a, r, zk, z, zs, pre), split


VALID_CALL_TURNS = ("python", "native", "native", "python", "python", "native")


def valid_call_split(P, chain_id, commit_entry, kind):
    """The valid 10,000-validator verify_commit split into the commit loop
    (sign bytes and bv.add, up to the host prep), the host prep
    (prepare_batch, RLC scalars), the copies to the device (synchronized)
    and the kernel with its sync (launch to collect_rlc's end), each call
    with the launch counts set to 0 just before it and held to one RLC
    launch; in turns VALID_CALL_TURNS, on both host-prep routes, under
    TM_TPU_ENGINE=off: the split instruments direct dispatch. Then the same
    call, native route, through the engine against direct dispatch in the
    turns ENGINE_TURNS. Returns the mean split of each route and the mean
    wall seconds of each mode."""
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, bid, commit = commit_entry
    n = SIZES[-1]
    prep_name = "prepare_batch" if kind == "ed25519" else "prepare_batch_sr"
    marks = {}

    def wrap(name, sync=False):
        fn = getattr(M, name)

        def timed_fn(*args, **kwargs):
            marks[f"{name}_start"] = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            marks[f"{name}_end"] = time.perf_counter()
            return out
        return fn, timed_fn

    wrapped = {name: wrap(name, sync) for name, sync in ((prep_name, False), ("_rlc_scalars", False),
                                                         ("_h2d", True), ("collect_rlc", False))}
    splits = {"python": [], "native": []}
    try:
        for name, (_, timed_fn) in wrapped.items():
            setattr(M, name, timed_fn)
        for route in VALID_CALL_TURNS:
            marks.clear()
            with native_setting(route == "python"), env_setting("TM_TPU_ENGINE", "off"):
                t0 = time.perf_counter()
                _, t = drive(f"{kind} valid call on {n} validators ({route} host prep)",
                             lambda: verify_commit(chain_id, vals, bid, commit.height, commit),
                             {P.rlc.__name__: 1}, {})
            m = {k: v - t0 for k, v in marks.items()}
            sp = {"s": t, "commit_loop_s": m[f"{prep_name}_start"],
                  "prepare_batch_s": m[f"{prep_name}_end"] - m[f"{prep_name}_start"],
                  "rlc_scalars_s": m["_rlc_scalars_end"] - m["_rlc_scalars_start"],
                  "h2d_s": m["_h2d_end"] - m["_h2d_start"],
                  "kernel_sync_s": m["collect_rlc_end"] - m["_h2d_end"]}
            sp["rest_s"] = sp["s"] - sum(v for k, v in sp.items() if k != "s")
            splits[route].append(sp)
            log(f"phase 4: {kind} valid {n}-validator call, {route} host prep, seconds: {json.dumps(sp)} "
                f"on {card()}")
    finally:
        for name, (fn, _) in wrapped.items():
            setattr(M, name, fn)
    # the same call through the engine (the default) against direct dispatch
    walls = {"direct": [], "engine": []}
    for mode in ENGINE_TURNS:
        with env_setting("TM_TPU_ENGINE", "off" if mode == "direct" else None):
            _, t = drive(f"{kind} valid call on {n} validators ({mode})",
                         lambda: verify_commit(chain_id, vals, bid, commit.height, commit),
                         {P.rlc.__name__: 1}, {})
        walls[mode].append(t)
    log(f"phase 4: {kind} valid {n}-validator call, native host prep, engine against direct dispatch "
        f"in the turns {ENGINE_TURNS}, ms: {json.dumps({m: [round(x * 1e3, 2) for x in v] for m, v in walls.items()})} "
        f"on {card()}")
    return ({route: {key: sum(sp[key] for sp in v) / len(v) for key in v[0]} for route, v in splits.items()},
            {mode: sum(v) / len(v) for mode, v in walls.items()})


def make_record(fn, splits, n, ms, p_ms, err, ops, nbytes, launches, int32_rate, name=None,
                library_ms=None):
    """One kernel's entry in the kernels record, its bound from this run's
    counts; logged as it is made."""
    name = name or kernel_label(fn, splits)
    b_ms, b_by = bound_ms(ops, nbytes, int32_rate)
    log(f"kernel {name} rows={n} == plain; kernel {ms:.3f} ms, plain {p_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {launches} launches on the main path")
    src, replaces = KERNEL_SOURCES[fn.__name__]
    rec = {"name": name, "route": "cuda", "source": f"tendermint_tpu_torch/{src}",
           "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "rows": n}
    if splits is not None:
        rec["splits"] = splits
    return rec


def expect_bitmap(name, out, pre, n, bad):
    ok = out[:n].cpu().numpy() & pre
    if ok[bad] or int(ok.sum()) != n - 1:
        raise AssertionError(f"{name}: bitmap on the tampered {n}-validator commit has "
                             f"{n - int(ok.sum())} invalid rows, #{bad} valid={bool(ok[bad])}")


def cache_kernels_at_main_path(P, dev, splits, jobs, bad, counts, errs, int32_rate):
    """A plane's cache fill and cache hit at one split, on the rows the
    tampered 1,000-validator commit gives them (1024): the fill against its
    plain version, and the hit through the main path's own cache of that
    split, which the path just filled (its slots and tables as
    dispatch_cached hands them to the kernel); both timed."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import verify as V

    fill, fill_plain, hit, hit_plain = cache_pair(P, splits)
    fill_fn, hit_fn = (P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit)
    n = len(jobs[0])
    a, r, s, k, pre = P.prepare(*jobs)
    k_rows = V.pad_pow2_rows([k], n)[0]
    a, r, s, k = V._to_device(V.pad_pow2_rows([a, r, s, k], n), dev)
    m = len(a)
    (tabs, oks), ms = event_ms(lambda: fill(a), 10)
    (ptabs, poks), p_ms = plain_ms(lambda: fill_plain(a))
    err = check_fill(kernel_label(fill_fn, splits), tabs, oks, ptabs, poks, all_decode=True)
    entry = 4096 * splits
    records = [make_record(fill_fn, splits, m, ms, p_ms, max(err, errs[kernel_label(fill_fn, splits)]),
                           P.ops_fill(m, splits), m * (32 + entry + 1),
                           counts.get(fill_fn.__name__, 0), int32_rate)]
    slots, cache_t, cache_o = P.cache(dev).ensure_snapshot(jobs[0])
    if cache_t.shape[1:] != tabs.shape[1:]:
        raise AssertionError(f"the main path's cache has entries {tuple(cache_t.shape[1:])}, "
                             f"not the split-{splits} entries {tuple(tabs.shape[1:])}")
    (slots,) = V._to_device([np.pad(slots, (0, m - n), mode="edge")], dev)
    args = (cache_t, cache_o, slots, r, s, k)
    got, ms = event_ms(lambda: hit(*args), 10)
    want, p_ms = plain_ms(lambda: hit_plain(*args))
    name = kernel_label(hit_fn, splits)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} rows differ from plain")
    expect_bitmap(name, got, pre, n, bad)
    records.append(make_record(hit_fn, splits, m, ms, p_ms, errs[name], P.ops_hit(m, splits),
                               m * (4 + 96 + 1 + 1) + cache_read_bytes(k_rows, splits),
                               counts.get(hit_fn.__name__, 0), int32_rate))
    return records


def kernels_at_main_path(P, dev, rng, chain_id, commits, bad_index, counts, errs, int32_rate, runs):
    """Hold one plane's kernels against their plain versions on the rows
    phase 3's commits give them (exact equality), check the verdicts, and
    time those same calls."""
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    def cuda(arrays):
        return V._to_device(arrays, dev)

    records = []

    # the uncached bitmap: the tampered 10,000-validator commit (16384 rows)
    n = SIZES[2]
    bad = bad_index[n]
    a, r, s, k, pre = P.prepare(*commit_jobs(commits[n], chain_id, bad))
    rows = cuda(V.pad_pow2_rows([a, r, s, k], n))
    got, ms = event_ms(lambda: P.bitmap(*rows), 5)
    want, p_ms = plain_ms(lambda: P.bitmap_plain(*rows))
    if not torch.equal(got, want):
        raise AssertionError(f"{P.bitmap.__name__}: {int((got != want).sum())} rows differ from plain")
    expect_bitmap(P.bitmap.__name__, got, pre, n, bad)
    m = len(rows[0])
    records.append(make_record(P.bitmap, None, m, ms, p_ms, errs[P.bitmap.__name__], P.ops_bitmap(m),
                               129 * m, counts[P.bitmap.__name__], int32_rate))
    log(f"phase 4: {P.bitmap.__name__} steps at {m} rows, device ms a call: "
        f"{json.dumps(step_times(lambda: P.bitmap(*rows), names=P.bitmap_steps)) or 'not measured'}")

    # the cache fill and the cache hit at the default split: the tampered
    # 1,000-validator commit (1024 rows)
    n = SIZES[1]
    records += cache_kernels_at_main_path(P, dev, DEFAULT_SPLITS, commit_jobs(commits[n], chain_id, bad_index[n]),
                                          bad_index[n], counts, errs, int32_rate)

    # the RLC: the 1,000- and 10,000-validator commits, valid and tampered,
    # with one z_raw for both verdicts; the largest shape is recorded
    for n in SIZES[1:]:
        z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
        verdicts = {}
        for verdict, bad in (("valid", None), ("tampered", bad_index[n])):
            timed_prep = n == SIZES[-1] and bad is None
            (a, r, zk, z, zs, pre), split = host_prep(P, commit_jobs(commits[n], chain_id, bad), n, z_raw,
                                                      timed_prep)
            if timed_prep:
                runs.append({"plane": P.kind, "commit": n, "run": "host prep of the RLC, native route",
                             "s": split["native_prepare_batch_s"] + split["native_rlc_scalars_s"], **split})
                log(f"phase 4: {P.kind} host prep of the valid {n}-validator commit, the same bytes on both "
                    f"routes, seconds (means of the turns {HOST_PREP_TURNS}): {json.dumps(split)} on {card()}")
            if not pre.all():
                raise AssertionError(f"{P.rlc.__name__}: the {verdict} {n}-validator commit fails the precheck")
            rows = cuda(V.pad_pow2_rows([a, r, zk, z], n) + [zs])
            if bad is None:  # time the valid polarity; it warms the plain version's shapes
                got, ms = event_ms(lambda: P.rlc(*rows), 5)
                want = P.rlc_plain(*rows)
            else:
                got = P.rlc(*rows)
                want, p_ms = plain_ms(lambda: P.rlc_plain(*rows), warm=False)
            if bool(got) != bool(want) or bool(got) != (bad is None):
                raise AssertionError(f"{P.rlc.__name__} ({verdict}, {n} validators): "
                                     f"kernel {bool(got)} plain {bool(want)}")
            verdicts[verdict] = bool(got)
            log(f"phase 4: {P.rlc.__name__} steps at {len(rows[0])} rows ({verdict}), device ms a call: "
                f"{json.dumps(step_times(lambda: P.rlc(*rows))) or 'not measured (no profiler device time)'}")
        m = len(rows[0])
        log(f"phase 4: {P.rlc.__name__} verdicts at {m} rows, same z_raw: {json.dumps(verdicts)}")
        rec = make_record(P.rlc, None, m, ms, p_ms, errs[P.rlc.__name__], P.ops_rlc(m, M._streams(m)),
                          m * (32 + 32 + 32 + 16) + 32 + 1, counts[P.rlc.__name__], int32_rate)

    # the valid 10,000-validator call, split, on both host-prep routes
    n = SIZES[-1]
    splits, walls = valid_call_split(P, chain_id, commits[n], P.kind)
    for route, sp in splits.items():
        runs.append({"plane": P.kind, "commit": n, "run": f"verify_commit valid, split, {route} host prep, "
                     f"mean of {VALID_CALL_TURNS.count(route)}", **sp})
    for mode, t in walls.items():
        runs.append({"plane": P.kind, "commit": n, "run": f"verify_commit valid, native host prep, {mode}, "
                     f"mean of {ENGINE_TURNS.count(mode)}", "s": t})
    return records + [rec]


# -- phase 4 (continued): the RLC and the split hits against the parent tree --

# One turn of the A/B: the RLC kernels, the uncached bitmaps, the fills and
# the cache hits of the tree in argv[1] (its package first on the path),
# timed on the inputs saved in argv[3] with this script's event_ms and
# step_times (argv[2] is this repo's root); in this tree's turns also the
# single-table hits' two-launch layout and block shapes and both designs of
# the single-table fills (build_ab_variants), each fill's bytes held to the
# entry point's; each verdict and bitmap checked; the times, and the ptxas
# reports of the libraries the turn built, written as JSON to argv[4].
AB_SCRIPT = r'''
import hashlib
import importlib.util
import json
import sys

import numpy as np
import torch

tree, root, inputs, out = sys.argv[1:5]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke_ab", f"{root}/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS

reports = _build.build_all(["msm", "msm_sr", "pk_tables", "sr_tables", "verify_cached",
                            "verify_sr_cached", "verify", "verify_sr", "pk_tables_single",
                            "sr_tables_single", "verify_cached_single",
                            "verify_sr_cached_single"])
data = np.load(inputs)
dev = torch.device("cuda", 0)
res = {"ptxas": {name: cs.ptxas_functions(rep) for name, rep in reports.items()}, "ms": {}}
variants = None
if tree == root:
    variants, variant_reports = cs.build_ab_variants(out + ".d")
    res["ptxas"].update(variant_reports)


def fill_digest(tables, oks):
    return hashlib.sha256(tables.cpu().numpy().tobytes() + oks.cpu().numpy().tobytes()).hexdigest()


for key in sorted({f.rsplit("__", 1)[0] for f in data.files}):
    what, plane, m, variant = key.split("__")
    sr = plane == "sr25519"
    if what == "rlc":
        rows = [torch.from_numpy(data[f"{key}__{c}"]).to(dev) for c in cs.AB_RLC_COLS]
        fn = M.msm_verify_sr_kernel if sr else M.msm_verify_kernel
        got, ms = cs.event_ms(lambda: fn(*rows), 10)
        if bool(got) != (variant == "valid"):
            raise SystemExit(f"{tree}: {key}: verdict {bool(got)}")
        res["ms"][key] = {"ms": ms, "steps": cs.step_times(lambda: fn(*rows))}
    elif what == "bitmap":
        rows = [torch.from_numpy(data[f"{key}__{c}"]).to(dev) for c in cs.AB_BITMAP_COLS[:-1]]
        fn = VS.verify_sr_kernel if sr else V.verify_kernel
        got, ms = cs.event_ms(lambda: fn(*rows), 10)
        if not np.array_equal(got.cpu().numpy(), data[f"{key}__want"]):
            raise SystemExit(f"{tree}: {key}: the bitmap differs from this tree's kernel's")
        steps = cs.step_times(lambda: fn(*rows), names=cs.SR_BITMAP_STEPS if sr else cs.BITMAP_STEPS)
        res["ms"][key] = {"ms": ms, "steps": steps}
    elif what == "fill1":
        a = torch.from_numpy(data[f"{key}__a"]).to(dev)
        fill = VS.build_sr_tables if sr else V.build_pk_tables
        (tables, oks), ms = cs.event_ms(lambda: fill(a), 10)
        digest = fill_digest(tables, oks)
        res["ms"][key] = {"ms": ms, "fill_sha256": digest}
        if variants is not None:
            for label, split_decode in (("design_a_ms", False), ("design_b_ms", True)):
                (tables, oks), ms = cs.event_ms(
                    lambda: cs.fill1_design(variants["fill1"], split_decode, sr, a), 10)
                if fill_digest(tables, oks) != digest:
                    raise SystemExit(f"{tree}: {key}: {label[:-3]} writes other bytes than the entry point")
                res["ms"][key][label] = ms
    else:
        a, *args = [torch.from_numpy(data[f"{key}__{c}"]).to(dev) for c in cs.AB_HIT_COLS[:-1]]
        fill, _, fn, _ = cs.cache_pair(cs.plane(plane), int(variant[1:]))
        (tables, oks), fill_ms = cs.event_ms(lambda: fill(a), 10)
        got, ms = cs.event_ms(lambda: fn(tables, oks, *args), 10)
        if not np.array_equal(got.cpu().numpy(), data[f"{key}__want"]):
            raise SystemExit(f"{tree}: {key}: the bitmap differs from this tree's kernel's")
        res["ms"][key] = {"ms": ms, "fill_ms": fill_ms, "fill_sha256": fill_digest(tables, oks)}
        if variant == "S1" and variants is not None:
            runs = {"two_launch_ms": lambda: cs.two_launch_hit(variants["two_launch"], sr, tables, oks, *args)}
            for w in range(1, 5):
                runs[f"w{w}_ms"] = lambda w=w: cs.fixed_w_hit(variants[plane], w, tables, oks, *args)
            for label, call in runs.items():
                got, ms = cs.event_ms(call, 10)
                if not np.array_equal(got.cpu().numpy(), data[f"{key}__want"]):
                    raise SystemExit(f"{tree}: {key}: the bitmap of {label[:-3]} differs")
                res["ms"][key][label] = ms
with open(out, "w") as f:
    json.dump(res, f)
'''
AB_TIMEOUT_S = 600

# The single-table hits' other layout, timed beside them in this tree's A/B
# turns and used nowhere else: a decode step of one thread a row writing
# -R (ed25519) or R (sr25519) and its decode bit to scratch, then a quad a
# row on coop.cuh's window loop under row 1's launch bound (80 registers),
# deciding as the kernels do (csrc/verify_cached_single.cu,
# csrc/verify_sr_cached_single.cu keep the decode in a warp beside the
# ladder instead).
HIT1_TWO_LAUNCH_SRC = r'''
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ristretto.cuh"

template <bool SR>
__global__ void hit1_decode(const uint8_t *r_enc, int32_t *rows, uint8_t *r_oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  bool ok;
  if (SR) {
    ok = ristretto_decode(p, r_enc + 32 * i);
  } else {
    ok = ge_decompress(p, r_enc + 32 * i);
    ge_neg(p, p);
  }
  r_oks[i] = ok ? 1 : 0;
  ge_store_row(rows + (size_t)i * 40, p);
}

template <bool SR>
__global__ void __launch_bounds__(128, 6)
    hit1_ladder(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                const uint8_t *s_bytes, const uint8_t *k_bytes, const int32_t *base_table,
                const int32_t *rows, const uint8_t *r_oks, uint8_t *out, int n, int capacity) {
  __shared__ int32_t sh_b[16 * B_SLOT];
  coop_base_to_shared(sh_b, base_table);
  const int q = threadIdx.x & 3;
  const int row_raw = blockIdx.x * 32 + threadIdx.x / 4, row = min(row_raw, n - 1);
  const int slot = cache_slot(slots[row], capacity);
  const int16_t *entry = tables + (size_t)slot * 16 * 128;
  fe mine;
  coop_straus_with(
      mine, q, sh_b,
      [entry, q](fe &x, fe &y, fe &w, int e) { coop_load_cached(x, y, w, entry, e, q); },
      s_bytes + 32 * row, k_bytes + 32 * row);
  const int32_t *r_row = rows + (size_t)row * 40;
  bool ok;
  if (SR) {
    ge qp, rp;
    fe_shfl(qp.X, mine, 0);
    fe_shfl(qp.Y, mine, 1);
    fe_load_coord(rp.X, r_row, 0, 1);
    fe_load_coord(rp.Y, r_row, 1, 1);
    ok = ristretto_equal(rp, qp);
  } else {
    ok = coop_cofactored_identity(mine, q, r_row);
  }
  if (q == 0 && row_raw < n) out[row] = (oks[slot] && r_oks[row] && ok) ? 1 : 0;
}

template <bool SR>
static int launch(const void *tables, const void *oks, const void *slots, const void *r_enc,
                  const void *s_bytes, const void *k_bytes, const void *base_table,
                  void *scratch, void *out, int n, int capacity, cudaStream_t st) {
  int32_t *rows = (int32_t *)scratch;
  uint8_t *r_oks = (uint8_t *)(rows + (size_t)40 * n);
  hit1_decode<SR><<<grid_for(n, 128), 128, 0, st>>>((const uint8_t *)r_enc, rows, r_oks, n);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  hit1_ladder<SR><<<grid_for(4 * n, 128), 128, 0, st>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)s_bytes, (const uint8_t *)k_bytes, (const int32_t *)base_table, rows,
      r_oks, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}

extern "C" int tm_hit1_two_launch(int sr, const void *tables, const void *oks, const void *slots,
                                  const void *r_enc, const void *s_bytes, const void *k_bytes,
                                  const void *base_table, void *scratch, void *out, int n,
                                  int capacity, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return sr ? launch<true>(tables, oks, slots, r_enc, s_bytes, k_bytes, base_table, scratch, out,
                           n, capacity, st)
            : launch<false>(tables, oks, slots, r_enc, s_bytes, k_bytes, base_table, scratch, out,
                            n, capacity, st);
}
'''


# An entry point appended to a single-table hit's source, taking the
# ladder warps a block (W) from its caller instead of coop.cuh hit1_warps,
# so that the A/B times the kernel at each block shape.
HIT1_FIXED_W_SRC = r'''
extern "C" int tm_hit1_fixed_w(int warps, const void *tables, const void *oks, const void *slots,
                               const void *r_enc, const void *s_bytes, const void *k_bytes,
                               const void *base_table, void *out, int n, int capacity,
                               void *stream) {
  KERNEL<<<grid_for(n, warps * HIT1_ROWS), 32 * (warps + 1), 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)base_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
'''
HIT1_KERNELS = {"ed25519": ("verify_cached_single", "verify_cached_single_rows"),
                "sr25519": ("verify_sr_cached_single", "verify_sr_cached_single_rows")}


# Both designs of the single-table fills, for this tree's A/B turns and
# nowhere else: a quad a key on coop.cuh's coop_fill at S = 1, decoding with
# the one-lane decoders (design A: ge_decompress, ristretto_decode, the four
# lanes running one chain each) or with coop_decode.cuh's quad-split ones
# (design B); csrc/pk_tables_single.cu and csrc/sr_tables_single.cu launch
# design B. Beside them one field product a thread (fe_mul, coop_fe_mul,
# coop_fe_sq), never launched, whose instructions cuobjdump counts.
FILL1_DESIGNS_SRC = r'''
#include <cuda_runtime.h>

#include "coop_decode.cuh"

template <int WHICH>
__global__ void product_probe(const int32_t *in, int32_t *out) {
  fe f, g, h;
  fe_load_coord(f, in, 0, 1);
  fe_load_coord(g, in, 1, 1);
  const int q = threadIdx.x & 3;
  if constexpr (WHICH == 0)
    fe_mul(h, f, g);
  else if constexpr (WHICH == 1)
    coop_fe_mul(h, f, g, q);
  else
    coop_fe_sq(h, f, q);
  fe_store_coord(out, threadIdx.x, h);
}
template __global__ void product_probe<0>(const int32_t *, int32_t *);
template __global__ void product_probe<1>(const int32_t *, int32_t *);
template __global__ void product_probe<2>(const int32_t *, int32_t *);

template <bool SPLIT_DECODE, bool SR>
__global__ void __launch_bounds__(COOP_FILL_THREADS, 10)
    fill1_design(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n) {
  coop_fill(
      [](ge &p, const uint8_t *enc) {
        if constexpr (SR)
          return SPLIT_DECODE ? coop_ristretto_decode(p, enc) : ristretto_decode(p, enc);
        else
          return SPLIT_DECODE ? coop_ge_decompress(p, enc) : ge_decompress(p, enc);
      },
      a_enc, tables, oks, n, 1);
}

template <bool SPLIT_DECODE, bool SR>
static int launch(const void *a_enc, void *tables, void *oks, int n, cudaStream_t st) {
  fill1_design<SPLIT_DECODE, SR><<<grid_for(4 * n, COOP_FILL_THREADS), COOP_FILL_THREADS, 0, st>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_fill1_design(int split_decode, int sr, const void *a_enc, void *tables,
                               void *oks, int n, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (split_decode)
    return sr ? launch<true, true>(a_enc, tables, oks, n, st) : launch<true, false>(a_enc, tables, oks, n, st);
  return sr ? launch<false, true>(a_enc, tables, oks, n, st) : launch<false, false>(a_enc, tables, oks, n, st);
}
'''


def build_ab_variants(workdir: str):
    # the A/B's variants built against the imported package's csrc/ with its
    # nvcc flags, one nvcc each, all at once: the single-table hits' two-
    # launch layout (HIT1_TWO_LAUNCH_SRC), each plane's hit with
    # HIT1_FIXED_W_SRC, and the single-table fills' two designs
    # (FILL1_DESIGNS_SRC); returns ({"two_launch", "fill1" or plane: loaded
    # library}, {"hit1_two_launch", "fill1_designs": ptxas report parsed,
    # "fill1_sass": the fill source's SASS counts})
    import ctypes

    from tendermint_tpu_torch.ops import _build

    os.makedirs(workdir, exist_ok=True)
    sources = {"two_launch": HIT1_TWO_LAUNCH_SRC, "fill1": FILL1_DESIGNS_SRC}
    for kind, (name, kernel) in HIT1_KERNELS.items():
        with open(_build.CSRC / f"{name}.cu") as f:
            sources[kind] = f.read() + HIT1_FIXED_W_SRC.replace("KERNEL", kernel)
    procs = {}
    for kind, text in sources.items():
        src, lib = os.path.join(workdir, f"variant_{kind}.cu"), os.path.join(workdir, f"variant_{kind}.so")
        with open(src, "w") as f:
            f.write(text)
        procs[kind] = lib, start_process(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    libs, reports = {}, {}
    for kind, (lib, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the A/B variant {kind} "
                               f"(rc {proc.returncode}):\n{log_text}")
        so = libs[kind] = ctypes.CDLL(lib)
        if kind == "fill1":
            reports["fill1_designs"] = ptxas_functions(log_text)
            reports["fill1_sass"] = sass_counts(lib)
            so.tm_fill1_design.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                                           + [ctypes.c_int, ctypes.c_void_p])
            so.tm_fill1_design.restype = ctypes.c_int
        elif kind == "two_launch":
            reports["hit1_two_launch"] = ptxas_functions(log_text)
            so.tm_hit1_two_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                                              + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            so.tm_hit1_two_launch.restype = ctypes.c_int
        else:
            so.tm_hit1_fixed_w.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            so.tm_hit1_fixed_w.restype = ctypes.c_int
    return libs, reports


PRODUCT_PROBES = {"product_probe<0>": "fe_mul", "product_probe<1>": "coop_fe_mul",
                  "product_probe<2>": "coop_fe_sq"}


def sass_counts(lib: str):
    """{kernel: {"instructions": n, opcode: n, ...}} of a library's SASS
    (cuobjdump -sass), NOPs left out, names as ptxas_functions gives them."""
    from tendermint_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = run_process([cuobjdump, "-sass", lib], 300, "cuobjdump").stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = ptxas_functions(f"Function properties for {m.group(1)}\nUsed 0 registers")[0][0]
            out[fn] = {"instructions": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn and m.group(1) != "NOP":
            op = m.group(1).split(".")[0] + (".WIDE" if ".WIDE" in m.group(1) else "")
            out[fn]["instructions"] += 1
            out[fn][op] = out[fn].get(op, 0) + 1
    return out


def fill1_design(so, split_decode: bool, sr: bool, a):
    # a single-table fill's (tables, decode bits) by design B (split_decode)
    # or A, on CUDA tensors
    import torch

    from tendermint_tpu_torch.ops import _build

    n = a.shape[0]
    tables = torch.empty((n, 16, 4, 32), dtype=torch.int16, device=a.device)
    oks = torch.empty(n, dtype=torch.bool, device=a.device)
    rc = so.tm_fill1_design(int(split_decode), int(sr), a.data_ptr(), tables.data_ptr(),
                            oks.data_ptr(), n, _build.stream_of(a))
    _build.check(rc, f"the single-table fill's design {'B' if split_decode else 'A'}")
    return tables, oks


def fixed_w_hit(so, warps: int, tables, oks, slots, r, s, k):
    # a single-table hit's bitmap by its kernel at W ladder warps a block
    import torch

    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import verify as V

    out = torch.empty(r.shape[0], dtype=torch.bool, device=r.device)
    rc = so.tm_hit1_fixed_w(warps, tables.data_ptr(), oks.data_ptr(), slots.data_ptr(), r.data_ptr(),
                            s.data_ptr(), k.data_ptr(), V.device_table("base", r.device).data_ptr(),
                            out.data_ptr(), r.shape[0], tables.shape[0], _build.stream_of(r))
    _build.check(rc, f"the single-table hit at W = {warps}")
    return out


def two_launch_hit(so, sr: bool, tables, oks, slots, r, s, k):
    # the single-table hit's bitmap by the two-launch layout, on CUDA tensors
    import torch

    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import verify as V

    n = r.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=r.device)
    scratch = torch.empty(40 * n + (n + 3) // 4, dtype=torch.int32, device=r.device)
    rc = so.tm_hit1_two_launch(int(sr), tables.data_ptr(), oks.data_ptr(), slots.data_ptr(),
                               r.data_ptr(), s.data_ptr(), k.data_ptr(),
                               V.device_table("base", r.device).data_ptr(), scratch.data_ptr(),
                               out.data_ptr(), n, tables.shape[0], _build.stream_of(r))
    _build.check(rc, "the two-launch single-table hit")
    return out
AB_RLC_COLS = ("a", "r", "zk", "z", "zs")
AB_HIT_COLS = ("a", "slots", "r", "s", "k", "want")
AB_HIT_SPLITS = (2, 4, 8)
AB_BITMAP_COLS = ("a", "r", "s", "k", "want")


def ab_inputs(planes, dev, chain_id, commits, bad_index, rng):
    """The A/B's inputs as named arrays: the RLC's rows of the 1,000- and
    10,000-validator commits (1,024 and 16,384), valid and tampered with
    one z_raw; the cache hits' rows of the tampered 1,000-validator commit
    (1,024) at S = 1, 2, 4 and 8, and of the tampered 10,000-validator one
    at row 15's shapes (10,240 rows and the 2,560-row shard of the bad row)
    at S = 1 and 4, each with the keys its cache holds (slot i for key i)
    and the bitmap this tree's hit gives them; each turn fills the tables
    with its tree's fill, timed (the split fills, rows 2 and 12, at 1,024
    keys and S = 2, 4, 8 and at 10,240 keys and S = 4; the single-table
    fills at S = 1) and hashed, for the two trees' fills must write the
    same bytes; the same 1,024 keys for the
    single-table fills (rows 5 and 10), timed and hashed, and at 4,096 and
    10,240 keys of the 10,000-validator commit; and the uncached
    bitmaps' rows (rows 1 and 9) of the tampered 10,000-validator commit at
    16,384 (verify_commit's), 10,240 and 2,560 (row 14's) and 8 rows (the
    autotune's size), with this tree's bitmap."""
    import numpy as np

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    arrays = {}
    for kind, P in planes.items():
        for n in SIZES[1:]:
            z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
            for verdict, bad in (("valid", None), ("tampered", bad_index[n])):
                (a, r, zk, z, zs, _), _ = host_prep(P, commit_jobs(commits[kind][n], chain_id, bad), n, z_raw)
                rows = V.pad_pow2_rows([a, r, zk, z], n) + [zs]
                for col, x in zip(AB_RLC_COLS, rows):
                    arrays[f"rlc__{kind}__{len(rows[0])}__{verdict}__{col}"] = x
        n = SIZES[2]
        bad = bad_index[n]
        a, r, s, k, _ = P.prepare(*commit_jobs(commits[kind][n], chain_id, bad))
        m, q = SV.shard_rows(n, 1), SV.shard_rows(n, 4)
        shard = SV._pad_rows([a, r, s, k], m)
        for rows in (V.pad_pow2_rows([a, r, s, k], n), shard,
                     [x[bad // q * q:(bad // q + 1) * q] for x in shard], [x[:8] for x in shard]):
            rows = [np.ascontiguousarray(x) for x in rows]
            want = P.bitmap(*V._to_device(rows, dev)).cpu().numpy()
            for col, x in zip(AB_BITMAP_COLS, rows + [want]):
                arrays[f"bitmap__{kind}__{len(rows[0])}__rows__{col}"] = x
        for n, splits_list in ((SIZES[1], (1,) + AB_HIT_SPLITS), (SIZES[2], (1, DEFAULT_SPLITS))):
            bad = bad_index[n]
            a, r, s, k, _ = P.prepare(*commit_jobs(commits[kind][n], chain_id, bad))
            if n == SIZES[2]:  # row 15's shapes: 10,240 rows and the 2,560-row shard of the bad row
                m, q = SV.shard_rows(n, 1), SV.shard_rows(n, 4)
                a, r, s, k = SV._pad_rows([a, r, s, k], m)
                shapes = (slice(0, m), slice(bad // q * q, (bad // q + 1) * q))
                # the single-table fills at row 15's 10,240 keys and at
                # PubkeyCache's default capacity, the largest fill a real
                # cache takes
                for keys in (m, 4096):
                    arrays[f"fill1__{kind}__{keys}__S1__a"] = np.ascontiguousarray(a[:keys])
            else:
                a, r, s, k = V.pad_pow2_rows([a, r, s, k], n)
                shapes = (slice(0, len(a)),)
                arrays[f"fill1__{kind}__{len(a)}__S1__a"] = a
            (a_d,) = V._to_device([a], dev)
            for splits in splits_list:
                fill, _, hit, _ = cache_pair(P, splits)
                tables, oks = fill(a_d)
                for sl in shapes:
                    slots = np.arange(len(a), dtype=np.int32)[sl]
                    args = V._to_device([slots, r[sl], s[sl], k[sl]], dev)
                    key = f"hit__{kind}__{len(slots)}__S{splits}"
                    want = hit(tables, oks, *args).cpu().numpy()
                    for col, x in zip(AB_HIT_COLS, (a, slots, r[sl], s[sl], k[sl], want)):
                        arrays[f"{key}__{col}"] = x
    return arrays


def ab_parent(planes, dev, chain_id, commits, bad_index, rng, parent, tmp):
    """Kernels 4 and 8, the uncached bitmaps (kernels 1 and 9, and row 14's
    shapes), the fills (the split kernels 2 and 12 and the single-table
    kernels 5 and 10, whose tables must hash the same in every turn) and
    the cache hits (the split kernels 3 and 13, the single-table kernels 6
    and 11, and row 15's shapes) of the parent tree (its package at
    `parent`) against this tree's, in turns parent, new, new, parent, each
    turn a process of its own, on ab_inputs' rows: mean ms of 10 launches
    by CUDA events, the RLC's and the bitmaps' steps by torch.profiler;
    in this tree's turns, beside the single-table hits their two-launch
    layout (HIT1_TWO_LAUNCH_SRC) and block shapes on the same rows, and
    beside the single-table fills both designs (FILL1_DESIGNS_SRC) on the
    same keys. Logs each tree's ptxas report of the bitmaps, the fills and
    the hits and the SASS counts of the fill designs and one field product,
    one line an input, and returns the turns."""
    import numpy as np
    import torch

    inputs = os.path.join(tmp, "ab_inputs.npz")
    np.savez(inputs, **ab_inputs(planes, dev, chain_id, commits, bad_index, rng))
    script = os.path.join(tmp, "ab.py")
    with open(script, "w") as f:
        f.write(AB_SCRIPT)
    turns = []
    for i, (label, tree) in enumerate((("parent", parent), ("new", ROOT), ("new", ROOT), ("parent", parent))):
        out = os.path.join(tmp, f"ab{i}.json")
        proc = run_process([sys.executable, script, tree, ROOT, inputs, out], AB_TIMEOUT_S, f"A/B turn {i}",
                           check=False, cwd=tree)
        if proc.returncode != 0:
            raise AssertionError(f"A/B turn {i} ({label}, {tree}) failed (rc {proc.returncode}):\n"
                                 f"{(proc.stdout + proc.stderr)[-3000:]}")
        with open(out) as f:
            turns.append((label, json.load(f)))
    logged = set()  # a tree's turns build the same variants: one line each
    for label, res in turns:
        for fn, counts in res["ptxas"].get("fill1_sass", {}).items():
            if (fn in PRODUCT_PROBES or fn.startswith("fill1_design")) and (label, fn) not in logged:
                logged.add((label, fn))
                ops = {op: n for op, n in counts.items() if op in ("IMAD", "IMAD.WIDE", "SHFL", "SEL")}
                log(f"ab: {label} tree SASS of {PRODUCT_PROBES.get(fn, fn)}: {counts['instructions']} "
                    f"instructions, {json.dumps(ops)}")
        for name, fns in res["ptxas"].items():
            if name in ("verify_cached", "verify_sr_cached", "verify", "verify_sr", "pk_tables",
                        "sr_tables", "pk_tables_single", "sr_tables_single", "verify_cached_single",
                        "verify_sr_cached_single", "hit1_two_launch", "fill1_designs"):
                for fn, regs, spills in fns:
                    if (label, name, fn) not in logged:
                        logged.add((label, name, fn))
                        log(f"ab: {label} tree {name}: {fn}: {regs} registers, {spills}")
    data = np.load(inputs)
    for key in turns[0][1]["ms"]:
        ms = {label: " / ".join("%.3f" % t["ms"][key]["ms"] for lab, t in turns if lab == label)
              for label in ("parent", "new")}
        what, plane, rows, variant = key.split("__")
        if what == "rlc":
            steps = {label: next(t["ms"][key]["steps"] for lab, t in turns if lab == label)
                     for label in ("parent", "new")}
            log(f"ab: {plane} RLC {rows} rows {variant}, ms a call (turns 1 and 4 / 2 and 3): parent "
                f"{ms['parent']}, new {ms['new']}; steps parent {json.dumps(steps['parent'])} "
                f"new {json.dumps(steps['new'])}")
        elif what == "bitmap":
            steps = {label: next(t["ms"][key]["steps"] for lab, t in turns if lab == label)
                     for label in ("parent", "new")}
            log(f"ab: {plane} uncached bitmap {rows} rows, ms a call (turns 1 and 4 / 2 and 3): parent "
                f"{ms['parent']}, new {ms['new']}; steps parent {json.dumps(steps['parent'])} "
                f"new {json.dumps(steps['new'])}")
        elif what == "fill1":
            digests = {t["ms"][key]["fill_sha256"] for _, t in turns}
            if len(digests) != 1:
                raise AssertionError(f"ab: {plane} single-table fill: the trees' tables differ ({digests})")
            designs = {c: " / ".join("%.3f" % t["ms"][key][c] for lab, t in turns if lab == "new")
                       for c in ("design_a_ms", "design_b_ms")}
            log(f"ab: {plane} single-table fill {rows} keys, ms a call (turns 1 and 4 / 2 and 3): parent "
                f"{ms['parent']}, new {ms['new']}; in turns 2 and 3 design A (one-lane decoders) "
                f"{designs['design_a_ms']}, design B (quad-split decoders) {designs['design_b_ms']}; "
                f"tables and decode bits byte-identical in all four turns and under both designs")
        else:
            kind = "single-table hit" if variant == "S1" else "split hit"
            log(f"ab: {plane} {kind} {rows} rows {variant[0]} = {variant[1:]}, ms a call (turns 1 and "
                f"4 / 2 and 3): parent {ms['parent']}, new {ms['new']}; bitmaps equal in all four turns")
            if variant == "S1":
                new = {c: " / ".join("%.3f" % t["ms"][key][c] for lab, t in turns if lab == "new")
                       for c in ("two_launch_ms", "w1_ms", "w2_ms", "w3_ms", "w4_ms")}
                w = 3 if -(-int(rows) // (3 * 8)) <= torch.cuda.get_device_properties(0).multi_processor_count else 4
                log(f"ab: {plane} single-table hit {rows} rows, ms a call (turns 2 and 3): the two-launch "
                    f"layout (a decode step, then the quad ladder) {new['two_launch_ms']}; this tree's "
                    f"kernel at W = 1, 2, 3, 4 ladder warps a block {new['w1_ms']}, {new['w2_ms']}, "
                    f"{new['w3_ms']}, {new['w4_ms']} (the entry point takes W = {w}); bitmaps equal")
            digests = {t["ms"][key]["fill_sha256"] for _, t in turns}
            if len(digests) != 1:
                raise AssertionError(f"ab: {plane} fill for {key}: the trees' tables differ ({digests})")
            if len(data[f"{key}__a"]) == int(rows):
                fill_ms = {label: " / ".join("%.3f" % t["ms"][key]["fill_ms"] for lab, t in turns
                                             if lab == label) for label in ("parent", "new")}
                kind = "single-table fill" if variant == "S1" else "split fill"
                log(f"ab: {plane} {kind} {rows} keys {variant[0]} = {variant[1:]}, ms a call (turns "
                    f"1 and 4 / 2 and 3): parent {fill_ms['parent']}, new {fill_ms['new']}; tables and "
                    f"decode bits byte-identical in all four turns")
    return turns


# -- phase 5: the other cache geometries --------------------------------------


def geometry_path(planes, dev, chain_id, commits, bad_index, errs, int32_rate, runs):
    """For S = 1, 2 and 8 (TM_TPU_PK_SPLIT), on each plane: verify_commit on
    the 150-validator commit (fill, then hit, through a new cache of that
    split) and on the tampered 1,000-validator commit (the RLC, then fill
    and hit), exact launches each; then the split's fill and hit against
    their plain versions on the rows that commit gives them, timed."""
    from tendermint_tpu_torch.types.validation import verify_commit

    small, mid, _ = SIZES
    records = []
    for splits in OTHER_SPLITS:
        os.environ["TM_TPU_PK_SPLIT"] = str(splits)
        for kind, P in planes.items():
            fill, hit = (P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit)
            totals = {}
            want = [{fill.__name__: 1, hit.__name__: 1},
                    {P.rlc.__name__: 1, fill.__name__: 1, hit.__name__: 1}]
            what = f"phase 5: {kind} S={splits}"
            vals, bid, commit = commits[kind][small]
            _, t = drive(f"{what} valid call on {small} validators",
                         lambda: verify_commit(chain_id, vals, bid, commit.height, commit), want[0], totals)
            runs.append({"plane": kind, "commit": small, "splits": splits, "run": "verify_commit valid",
                         "s": t})
            msg, t = verify_tampered(chain_id, commits[kind][mid], bad_index[mid], lambda fn: drive(
                f"{what} tampered call on {mid} validators", fn, want[1], totals))
            runs.append({"plane": kind, "commit": mid, "splits": splits,
                         "run": f"verify_commit tampered #{bad_index[mid]}", "s": t})
            check_path(what, totals, want)
            records += cache_kernels_at_main_path(
                P, dev, splits, commit_jobs(commits[kind][mid], chain_id, bad_index[mid]),
                bad_index[mid], totals, errs, int32_rate)
    os.environ["TM_TPU_PK_SPLIT"] = str(DEFAULT_SPLITS)
    return records


# -- phase 6: the cached RLC --------------------------------------------------


def rlc_cache_path(P, dev, rng, chain_id, commits, bad_index, errs, int32_rate, runs):
    """TM_TPU_MSM_CACHE=on on the ed25519 plane. For S = 2, 4 and 8, each
    through a new cache: the valid 1,000-validator commit with the knob off
    (the uncached RLC), then on (the fill and the cached RLC), then on
    again (the cached RLC alone); the tampered one (the cached RLC, then
    the cache hit); the 10,000-validator commit, whose keys overflow the
    cache (the uncached RLC). At S = 1 the knob takes the uncached RLC.
    Then the cached RLC against its plain version on the 1,000-validator
    commit's rows in both verdicts with one z_raw, timed."""
    import numpy as np

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.types.validation import verify_commit

    small, mid, large = SIZES
    rlc, cached = P.rlc.__name__, M.msm_verify_kernel_cached.__name__
    records = []

    def valid(n):
        vals, bid, commit = commits[n]
        return lambda: verify_commit(chain_id, vals, bid, commit.height, commit)

    for splits in RLC_CACHE_SPLITS + (1,):
        os.environ["TM_TPU_PK_SPLIT"] = str(splits)
        V._PK_CACHES.clear()  # a new cache of this split
        what = f"phase 6: S={splits}"
        totals = {}
        if splits == 1:
            os.environ["TM_TPU_MSM_CACHE"] = "on"
            drive(f"{what} valid call on {mid} validators", valid(mid), {rlc: 1}, totals)
            check_path(what, totals, [{rlc: 1}])
            continue
        fill, hit = P.fill.__name__, P.hit.__name__
        want = [{rlc: 1}, {fill: 1, cached: 1}, {cached: 1}, {cached: 1, hit: 1}, {rlc: 1}]
        os.environ["TM_TPU_MSM_CACHE"] = "off"
        _, t_off = drive(f"{what} MSM_CACHE=off valid call on {mid} validators", valid(mid), want[0], totals)
        os.environ["TM_TPU_MSM_CACHE"] = "on"
        _, t_fill = drive(f"{what} first valid call on {mid} validators", valid(mid), want[1], totals)
        _, t_on = drive(f"{what} second valid call on {mid} validators", valid(mid), want[2], totals)
        runs.append({"plane": P.kind, "commit": mid, "splits": splits,
                     "run": "verify_commit valid: RLC uncached / cached with fill / cached",
                     "s": t_on, "uncached_s": t_off, "fill_s": t_fill})
        verify_tampered(chain_id, commits[mid], bad_index[mid], lambda fn: drive(
            f"{what} tampered call on {mid} validators", fn, want[3], totals))
        drive(f"{what} valid call on {large} validators", valid(large), want[4], totals)
        check_path(what, totals, want)

        # kernel 7 on the 1,000-validator commit's rows, valid and tampered
        jobs = commit_jobs(commits[mid], chain_id)
        slots, cache_t, cache_o = P.cache(dev).ensure_snapshot(jobs[0])
        z_raw = M._ensure_z_raw(mid, rng.bytes(16 * mid))
        verdicts = {}
        for verdict, bad in (("valid", None), ("tampered", bad_index[mid])):
            _, r, s_rows, k_rows, pre = P.prepare(*commit_jobs(commits[mid], chain_id, bad))
            zk, z, zs = M._rlc_scalars(s_rows, k_rows, mid, z_raw)
            r, zk, z = V.pad_pow2_rows([r, zk, z], mid)
            m = len(r)
            args = V._to_device([np.pad(slots, (0, m - mid), mode="edge"), r, zk, z, zs], dev)
            if bad is None:
                got, ms = event_ms(lambda: M.msm_verify_kernel_cached(cache_t, cache_o, *args), 5)
                want_v, p_ms = plain_ms(lambda: M.msm_verify_kernel_cached_plain(cache_t, cache_o, *args))
                zk_rows = zk
            else:
                got = M.msm_verify_kernel_cached(cache_t, cache_o, *args)
                want_v = M.msm_verify_kernel_cached_plain(cache_t, cache_o, *args)
            if bool(got) != bool(want_v) or bool(got) != (bad is None):
                raise AssertionError(f"{kernel_label(M.msm_verify_kernel_cached, splits)} ({verdict}): "
                                     f"kernel {bool(got)} plain {bool(want_v)}")
            verdicts[verdict] = bool(got)
        log(f"{what}: {cached} verdicts at {m} rows, same z_raw: {json.dumps(verdicts)}")
        name = kernel_label(M.msm_verify_kernel_cached, splits)
        records.append(make_record(
            M.msm_verify_kernel_cached, splits, m, ms, p_ms, errs[name],
            ops_msm_cached(m, M._streams(m), splits),
            m * (4 + 32 + 32 + 16 + 1) + 32 + 1 + cache_read_bytes(zk_rows, splits),
            totals[cached], int32_rate))
    os.environ.pop("TM_TPU_MSM_CACHE", None)
    os.environ["TM_TPU_PK_SPLIT"] = str(DEFAULT_SPLITS)
    V._PK_CACHES.clear()
    return records


# -- phase 2 (continued): fail_count ---------------------------------------------


def check_fail_count(rng, dev):
    """fail_count against its plain version on edge inputs: bitmaps of B in
    1, 8, 255, 256 and 10,240 rows (bool and uint8) all true, all false,
    false at row 0 alone, at row B - 1 alone, and random; a () verdict of
    each value; int32 vectors of 1 to 8 counts."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    cases = []
    for b in (1, 8, 255, 256, 10240):
        for pattern in ("all true", "all false", "false at 0", "false at B-1", "random"):
            ok = np.ones(b, bool)
            if pattern == "all false":
                ok[:] = False
            elif pattern == "false at 0":
                ok[0] = False
            elif pattern == "false at B-1":
                ok[-1] = False
            elif pattern == "random":
                ok = rng.random(b) < 0.9
            cases += [(f"{pattern}, B={b}", torch.from_numpy(ok).to(dev)),
                      (f"{pattern}, B={b}, uint8", torch.from_numpy(ok.astype(np.uint8)).to(dev))]
    cases += [(f"verdict {v}", torch.tensor(v, device=dev)) for v in (True, False)]
    cases += [(f"{k} counts", torch.from_numpy(rng.integers(0, 10241, k).astype(np.int32)).to(dev))
              for k in range(1, 9)]
    for what, x in cases:
        got, want = SV.fail_count(x), SV.fail_count_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fail_count on {what}: kernel {got.tolist()} plain {want.tolist()}")
    log(f"phase 2: fail_count == plain on {len(cases)} edge inputs (bitmaps of 1-10,240 rows, "
        f"verdicts, 1-8 counts)")
    return {"fail_count": 0}


# -- phase 7: the sharded path ---------------------------------------------------

# One rank of verify_batch_sharded_local: joins the group (gloo when the
# backend device is "cpu", NCCL otherwise), verifies its quarter of the jobs
# in the .npz on the card and writes its bitmap, verdict, backend and launches.
RANK_SCRIPT = r'''
import sys

import numpy as np
import torch


def unpack(flat, lengths):
    ends = np.cumsum(lengths)
    return [flat[e - n:e].tobytes() for e, n in zip(ends, lengths)]


def rank_main(rank, world, init, backend_device, mesh_device, path, out_dir):
    import torch.distributed as dist

    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import multihost as mh
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    mh.initialize(init, world, rank, device=backend_device)
    mesh = mh.global_mesh(device=mesh_device)
    data = np.load(path)
    cols = [unpack(data[c], data[c + "_len"]) for c in ("pk", "msg", "sig")]
    per = len(cols[0]) // world
    V.verify_kernel.launches = SV.fail_count.launches = 0
    bitmap, ok = mh.verify_batch_sharded_local(mesh, *(c[rank * per:(rank + 1) * per] for c in cols))
    torch.cuda.synchronize()
    np.savez(f"{out_dir}/rank{rank}.npz", bitmap=bitmap, ok=np.array(ok),
             backend=np.array(dist.get_backend()),
             launches=np.array([V.verify_kernel.launches, SV.fail_count.launches]))
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    world = int(sys.argv[1])
    mp.spawn(rank_main, args=(world, *sys.argv[2:]), nprocs=world, join=True)
'''
RANK_TIMEOUT_S = 300


def _pack(items):
    import numpy as np

    return np.frombuffer(b"".join(items), np.uint8), np.array([len(x) for x in items], np.int64)


def run_ranks(tmp, world, backend_device, mesh_device, jobs):
    """verify_batch_sharded_local in `world` rank processes, each holding its
    share of `jobs`; fatal on failure or past RANK_TIMEOUT_S (the launcher's
    whole process group is killed). Returns each rank's saved outputs."""
    import signal

    import numpy as np

    run = os.path.join(tmp, f"{backend_device}-{world}")
    os.makedirs(run)
    arrays = {}
    for col, items in zip(("pk", "msg", "sig"), jobs):
        arrays[col], arrays[col + "_len"] = _pack(items)
    np.savez(os.path.join(run, "jobs.npz"), **arrays)
    script = os.path.join(run, "ranks.py")
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, script, str(world), f"file://{run}/rendezvous", backend_device, mesh_device,
           os.path.join(run, "jobs.npz"), run]
    proc = start_process(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{world} ranks ({backend_device}) hung past {RANK_TIMEOUT_S} s:\n"
                             f"{out[-3000:]}") from None
    if proc.returncode != 0:
        raise AssertionError(f"{world} ranks ({backend_device}) failed (rc {proc.returncode}):\n"
                             f"{out[-3000:]}")
    return [np.load(os.path.join(run, f"rank{r}.npz")) for r in range(world)]


def expect_sharded(what, bitmap, ok, n, bad):
    """A sharded call's (bitmap, verdict): every row valid and True, or row
    #bad alone invalid and False."""
    invalid = [i for i in range(n) if not bitmap[i]]
    if len(bitmap) != n or invalid != ([] if bad is None else [bad]) or ok is not (bad is None):
        raise AssertionError(f"{what}: {len(bitmap)} rows, invalid {invalid[:8]}, verdict {ok}; "
                             f"expected {n} rows, invalid {[] if bad is None else [bad]}")


def sharded_path(planes, meshes, dev, rng, chain_id, commits, bad_index, runs, tmp):
    """Phase 7's calls, each with every launch counter set to 0 just before
    it and read just after and held to its exact launches and sharded entry
    point; returns the summed launches."""
    import numpy as np

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    small, mid, large = SIZES
    fc = SV.fail_count.__name__
    totals, expected = {}, []

    def run(what, fn, want, entries):
        expected.append(want)
        return drive(f"phase 7: {what}", fn, want, totals, entries)

    # row 14: the bitmap plane on the 10,000-validator commits; the bitmap
    # equals the single-card one
    whole = {}
    for kind, P in planes.items():
        for verdict, bad in (("valid", None), ("tampered", bad_index[large])):
            jobs = commit_jobs(commits[kind][large], chain_id, bad)
            single = P.batch(*jobs, device=dev)
            for label, mesh in meshes.items():
                what = f"{kind} verify_batch_sharded on the {verdict} {large}-validator commit, mesh of {label}"
                (bitmap, ok), t = run(what, lambda: SV.verify_batch_sharded(mesh, *jobs, key_type=kind),
                                      {P.bitmap.__name__: mesh.size, fc: mesh.size + 1}, {"bitmap": 1})
                expect_sharded(what, bitmap, ok, large, bad)
                if not np.array_equal(bitmap, single):
                    raise AssertionError(f"{what}: the bitmap differs from the single-card verify_batch")
                runs.append({"plane": kind, "commit": large, "mesh": label, "s": t,
                             "run": f"verify_batch_sharded {verdict}"})
            whole[kind, verdict] = jobs, single

    # row 15: the cached plane on the 1,000-validator commits at S = 4 and
    # S = 1, each through new caches: the fill on the first call, then a
    # hit a shard; at S = 4 the 10,000 keys overflow to the uncached path
    for splits in (DEFAULT_SPLITS, 1):
        os.environ["TM_TPU_PK_SPLIT"] = str(splits)
        V._PK_CACHES.clear()
        for kind, P in planes.items():
            fill, hit = ((P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit))
            first = True
            for label, mesh in reversed(meshes.items()):
                for verdict, bad in (("valid", None), ("tampered", bad_index[mid])):
                    jobs = commit_jobs(commits[kind][mid], chain_id, bad)
                    want = {hit.__name__: mesh.size, fc: mesh.size + 1}
                    if first:
                        want[fill.__name__] = 1
                        first = False
                    what = (f"{kind} verify_batch_sharded_cached at S={splits} on the {verdict} "
                            f"{mid}-validator commit, mesh of {label}")
                    (bitmap, ok), t = run(what, lambda: SV.verify_batch_sharded_cached(
                        mesh, *jobs, key_type=kind), want, {"cached": 1})
                    expect_sharded(what, bitmap, ok, mid, bad)
                    runs.append({"plane": kind, "commit": mid, "mesh": label, "splits": splits, "s": t,
                                 "run": f"verify_batch_sharded_cached {verdict}"})
            if splits == DEFAULT_SPLITS:
                jobs, _ = whole[kind, "valid"]
                mesh = meshes["4"]
                what = f"{kind} verify_batch_sharded_cached on the valid {large}-validator commit (overflow)"
                (bitmap, ok), _ = run(what, lambda: SV.verify_batch_sharded_cached(mesh, *jobs, key_type=kind),
                                      {P.bitmap.__name__: mesh.size, fc: mesh.size + 1}, {"bitmap": 1})
                expect_sharded(what, bitmap, ok, large, None)
    os.environ["TM_TPU_PK_SPLIT"] = str(DEFAULT_SPLITS)
    V._PK_CACHES.clear()

    # row 16: the sharded RLC (ed25519) on the 1,000- and 10,000-validator
    # commits, one z_raw for both verdicts; then 10 signatures on the mesh
    # of 4, whose shards 2 and 3 hold padding only
    P = planes["ed25519"]
    for n in (mid, large):
        z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
        for verdict, bad in (("valid", None), ("tampered", bad_index[n])):
            jobs = commit_jobs(commits["ed25519"][n], chain_id, bad)
            for label, mesh in meshes.items():
                what = f"verify_batch_sharded_rlc on the {verdict} {n}-validator commit, mesh of {label}"
                ok, t = run(what, lambda: SV.verify_batch_sharded_rlc(mesh, *jobs, z_raw=z_raw),
                            {P.rlc.__name__: mesh.size, fc: mesh.size + 1}, {"rlc": 1})
                if ok is not (bad is None):
                    raise AssertionError(f"{what}: verdict {ok}")
                runs.append({"plane": "ed25519", "commit": n, "mesh": label, "s": t,
                             "run": f"verify_batch_sharded_rlc {verdict}"})
    ten = [x[:10] for x in commit_jobs(commits["ed25519"][mid], chain_id)]
    mesh = meshes["4"]
    for verdict, sigs in (("valid", ten[2]), ("tampered", ten[2][:9] + [tamper(ten[2][9])])):
        what = f"verify_batch_sharded_rlc on {verdict} 10 signatures, mesh of 4 (shards 2, 3 of padding)"
        ok, _ = run(what, lambda: SV.verify_batch_sharded_rlc(mesh, ten[0], ten[1], sigs),
                    {P.rlc.__name__: 4, fc: 5}, {"rlc": 1})
        if ok is not (verdict == "valid"):
            raise AssertionError(f"{what}: verdict {ok}")
    check_path("phase 7", totals, expected)

    # verify_batch_sharded_local across processes: one rank on NCCL, and four
    # ranks on gloo with their kernels on the card (NCCL refuses two ranks on
    # one GPU), each a quarter of the tampered 10,000-validator commit
    jobs, single = whole["ed25519", "tampered"]
    for world, backend_device in ((1, dev.type), (4, "cpu")):
        t0 = time.perf_counter()
        ranks = run_ranks(tmp, world, backend_device, str(dev), jobs)
        bitmap = np.concatenate([r["bitmap"] for r in ranks])
        oks = {bool(r["ok"]) for r in ranks}
        backends = {str(r["backend"]) for r in ranks}
        launches = {tuple(r["launches"].tolist()) for r in ranks}
        per = SV.shard_rows(large // world, 1)
        if not np.array_equal(bitmap, single) or oks != {False} or launches != {(1, 2)}:
            raise AssertionError(f"{world} ranks ({backends}): {int((bitmap != single).sum())} rows differ "
                                 f"from the whole bitmap, verdicts {oks}, launches {launches}")
        log(f"phase 7: verify_batch_sharded_local on {world} rank(s), backend {sorted(backends)}, kernels "
            f"and the reduced int32 on {dev}, {large // world} jobs ({per} rows) a rank: the concatenated "
            f"bitmap equals the "
            f"whole one, every rank False, launches (bitmap, fail_count) {sorted(launches)}, "
            f"{time.perf_counter() - t0:.1f} s with process start")
    return totals


def kernels_at_sharded_shapes(planes, dev, rng, chain_id, commits, bad_index, counts, int32_rate):
    """Each kernel of the sharded path against its plain version on the rows
    the sharded calls give it at 10,000 validators: 10,240 rows on the mesh
    of 1 and the shard of 2,560 that holds the tampered row on the mesh of
    4, exact, timed with CUDA events; the cache kernels at S = 4 and S = 1
    through tables that their fill built for the commit's 10,240 keys;
    fail_count beside torch.sum on the 10,240-row bitmap."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    n = SIZES[-1]
    bad = bad_index[n]
    m, q = SV.shard_rows(n, 1), SV.shard_rows(n, 4)
    d = bad // q
    shapes = ((m, slice(0, m)), (q, slice(d * q, (d + 1) * q)))
    records = []

    def check_bitmap(name, got, want, sl):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} rows differ from plain")
        host = got.cpu().numpy()
        invalid = [i + (sl.start or 0) for i in np.flatnonzero(~host)]
        if invalid != [bad]:
            raise AssertionError(f"{name}: invalid rows {invalid[:8]}, expected [{bad}]")

    for kind, P in planes.items():
        a, r, s, k, pre = P.prepare(*commit_jobs(commits[kind][n], chain_id, bad))
        rows = SV._pad_rows([a, r, s, k], m)
        for rows_n, sl in shapes:
            args = V._to_device([x[sl] for x in rows], dev)
            name = f"{P.bitmap.__name__}[rows={rows_n}]"
            got, ms = event_ms(lambda: P.bitmap(*args), 5)
            want, p_ms = plain_ms(lambda: P.bitmap_plain(*args), warm=False)
            check_bitmap(name, got, want, sl)
            records.append(make_record(P.bitmap, None, rows_n, ms, p_ms, 0, P.ops_bitmap(rows_n),
                                       129 * rows_n, counts.get(P.bitmap.__name__, 0), int32_rate, name))
            if kind == "ed25519" and rows_n == m:
                records.append(fail_count_record(got, counts.get("fail_count", 0), int32_rate))
        (a_d,) = V._to_device([rows[0]], dev)
        for splits in (DEFAULT_SPLITS, 1):
            fill, fill_plain, hit, hit_plain = cache_pair(P, splits)
            fill_fn, hit_fn = (P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit)
            name = f"{kernel_label(fill_fn, splits)}[S={splits},rows={m}]"
            (tabs, oks), ms = event_ms(lambda: fill(a_d), 5)
            (ptabs, poks), p_ms = plain_ms(lambda: fill_plain(a_d), warm=False)
            err = check_fill(name, tabs, oks, ptabs, poks, all_decode=True)
            del ptabs, poks
            records.append(make_record(fill_fn, splits, m, ms, p_ms, err, P.ops_fill(m, splits),
                                       m * (32 + 4096 * splits + 1), counts.get(fill_fn.__name__, 0),
                                       int32_rate, name))
            slots = torch.arange(m, dtype=torch.int32, device=dev)
            for rows_n, sl in shapes:
                args = (tabs, oks, slots[sl].contiguous(), *V._to_device([x[sl] for x in rows[1:]], dev))
                name = f"{kernel_label(hit_fn, splits)}[S={splits},rows={rows_n}]"
                got, ms = event_ms(lambda: hit(*args), 5)
                want, p_ms = plain_ms(lambda: hit_plain(*args), warm=False)
                check_bitmap(name, got, want, sl)
                records.append(make_record(hit_fn, splits, rows_n, ms, p_ms, 0, P.ops_hit(rows_n, splits),
                                           rows_n * (4 + 96 + 1 + 1) + cache_read_bytes(rows[3][sl], splits),
                                           counts.get(hit_fn.__name__, 0), int32_rate, name))
            del tabs, oks

    # the RLC (ed25519): the whole commit at 10,240 rows and the shard of
    # 2,560 with its own scalars, both verdicts with one z_raw
    P = planes["ed25519"]
    z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
    for rows_n, sl in shapes:
        lo, hi = sl.start, min(sl.stop, n)
        verdicts = {}
        for verdict, b in (("valid", None), ("tampered", bad)):
            a, r, s, k, _ = P.prepare(*commit_jobs(commits["ed25519"][n], chain_id, b))
            zk, z, zs = M._rlc_scalars(s[lo:hi], k[lo:hi], hi - lo, z_raw[16 * lo:16 * hi])
            args = V._to_device(SV._pad_rows([a[lo:hi], r[lo:hi], zk, z], rows_n) + [zs], dev)
            if b is None:
                got, ms = event_ms(lambda: P.rlc(*args), 5)
                want = P.rlc_plain(*args)
            else:
                got = P.rlc(*args)
                want, p_ms = plain_ms(lambda: P.rlc_plain(*args), warm=False)
            if bool(got) != bool(want) or bool(got) != (b is None):
                raise AssertionError(f"{P.rlc.__name__}[rows={rows_n}] ({verdict}): kernel {bool(got)} "
                                     f"plain {bool(want)}")
            verdicts[verdict] = bool(got)
        log(f"phase 7: {P.rlc.__name__} verdicts at {rows_n} rows, same z_raw: {json.dumps(verdicts)}")
        records.append(make_record(P.rlc, None, rows_n, ms, p_ms, 0, P.ops_rlc(rows_n, M._streams(rows_n)),
                                   rows_n * (32 + 32 + 32 + 16) + 32 + 1, counts.get(P.rlc.__name__, 0),
                                   int32_rate, f"{P.rlc.__name__}[rows={rows_n}]"))
    return records


def fail_count_record(bitmap, launches, int32_rate):
    """fail_count on a bitmap the path made, timed beside its plain version
    and one PyTorch call, (~ok).sum(); bound: the bitmap read once and one
    int32 written, one compare and one add a row."""
    import torch

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    n = bitmap.numel()
    got, ms = event_ms(lambda: SV.fail_count(bitmap), 50)
    want, p_ms = event_ms(lambda: SV.fail_count_plain(bitmap), 50)
    lib, lib_ms = event_ms(lambda: (~bitmap).sum(), 50)
    if not torch.equal(got, want) or int(got) != int(lib):
        raise AssertionError(f"fail_count: kernel {int(got)} plain {int(want)} torch.sum {int(lib)}")
    return make_record(SV.fail_count, None, n, ms, p_ms, 0, 2 * n, n + 4, launches, int32_rate,
                       library_ms=lib_ms)


E2E_ROUNDS = 5


def sharded_end_to_end(planes, meshes, dev, chain_id, commits, runs):
    """verify_batch_sharded on the mesh of 1 (10,240 rows) and on the mesh
    of 4 against the single-card verify_batch (16,384 rows) on the valid
    10,000-validator commit of each plane: E2E_ROUNDS rounds, the three in
    a rotating order each round; the medians are recorded."""
    import statistics

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    n = SIZES[-1]
    for kind, P in planes.items():
        jobs = commit_jobs(commits[kind][n], chain_id)
        calls = {"sharded_1": lambda: SV.verify_batch_sharded(meshes["1"], *jobs, key_type=kind),
                 "single": lambda: P.batch(*jobs, device=dev),
                 "sharded_4": lambda: SV.verify_batch_sharded(meshes["4"], *jobs, key_type=kind)}
        keys = list(calls)
        t = {key: [] for key in keys}
        for r in range(E2E_ROUNDS):
            for key in keys[r % 3:] + keys[:r % 3]:
                t[key].append(timed(calls[key])[1])
        med = {key: statistics.median(v) for key, v in t.items()}
        runs.append({"plane": kind, "commit": n, "run": f"end to end, median of {E2E_ROUNDS}: sharded "
                     "mesh of 1 / single card / sharded mesh of 4", "s": med["sharded_1"],
                     "single_s": med["single"], "mesh4_s": med["sharded_4"]})
        log(f"phase 7: {kind} end to end on {n} validators, seconds a call: {json.dumps(t)}")


# -- phase 8: the cutover autotune -------------------------------------------------

# A fresh process with the cutovers unpinned and TM_TPU_AUTOTUNE unset: a
# 4-signature batch verify (below every cutover, so the host path) starts the
# probe on the card; the probe's thread is joined; writes what the probe
# recorded, the cutovers and the launch counts as JSON to argv[2].
AUTOTUNE_SCRIPT = r'''
import importlib.util
import json
import os
import sys

root, out = sys.argv[1:3]
for var in ("TM_TPU_AUTOTUNE", "TM_TPU_BATCH_CUTOVER", "TM_TPU_MSM_CUTOVER"):
    os.environ.pop(var, None)
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke_autotune", f"{root}/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import engine as E

cs.reset_counts()
priv = ref.gen_privkey(bytes(32))
bv = ed.Ed25519BatchVerifier()
for i in range(4):
    msg = b"autotune-%d" % i
    bv.add(ed.Ed25519PubKey(priv[32:]), msg, ref.sign(priv, msg))
ok, _ = bv.verify()
probe = E._AUTOTUNE.get("thread")
if probe is not None:
    probe.join(timeout=300)
rec = {k: (repr(v) if k in ("error", "thread") else v) for k, v in E._AUTOTUNE.items()}
with open(out, "w") as f:
    json.dump({"ok": ok, "alive": probe is not None and probe.is_alive(), "autotune": rec,
               "cutovers": [ed.DEVICE_BATCH_CUTOVER, ed.MSM_BATCH_CUTOVER],
               "launches": {k: v for k, v in cs.read_counts().items() if v}}, f)
'''


def autotune_phase(tmp):
    """The probe on the card in a fresh process: it must start, end, record
    no exception, set the cutovers to the reference's formula from its two
    timings, and launch the 8-signature bitmap exactly 4 times (one warm-up,
    three timed); the batch itself stays on the host."""
    script, out = os.path.join(tmp, "autotune.py"), os.path.join(tmp, "autotune.json")
    with open(script, "w") as f:
        f.write(AUTOTUNE_SCRIPT)
    proc = run_process([sys.executable, script, ROOT, out], 600, "phase 8", check=False, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"phase 8 failed (rc {proc.returncode}):\n{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    rec = res["autotune"]
    if "error" in rec or res["alive"] or "thread" not in rec or not res["ok"]:
        raise AssertionError(f"phase 8: the probe did not run to its end cleanly: {json.dumps(res)}")
    cutover = 8
    while cutover * rec["t_host"] < rec["t_launch"] and cutover < 4096:
        cutover *= 2
    want = [cutover, max(64, min(4 * cutover, 8192))]
    got = [rec["device_batch_cutover"], rec["msm_batch_cutover"]]
    if got != want or res["cutovers"] != want:
        raise AssertionError(f"phase 8: cutovers {got} (module {res['cutovers']}), the formula gives {want}")
    if res["launches"] != {"verify_kernel": 4}:
        raise AssertionError(f"phase 8: launched {res['launches']}, expected {{'verify_kernel': 4}}")
    log(f"phase 8: autotune probe: t_host {rec['t_host'] * 1e3:.4f} ms a host verify, t_launch "
        f"{rec['t_launch'] * 1e3:.4f} ms an 8-signature bitmap call -> DEVICE_BATCH_CUTOVER {got[0]}, "
        f"MSM_BATCH_CUTOVER {got[1]} (the formula's); launches {json.dumps(res['launches'])}")
    return rec


# -- phase 9: the engine on the card ------------------------------------------------

ENGINE_TURNS = ("direct", "engine", "engine", "direct")
# phase 9 (a)'s groups: (validators, commits, the tampered commit or None)
COALESCE_GROUPS = ((67, 3, None), (1000, 4, 2))
# phase 9 (d)'s concurrent callers: (validators, threads), ed25519
CALLER_MIXES = ((150, 8), (1000, 4))


@contextlib.contextmanager
def env_setting(name: str, value):
    """os.environ[name] = value inside the block (None: unset), restored
    after."""
    before = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if before is not None:
            os.environ[name] = before


def engine_commits(pool, rng, keys, chain_id):
    """Phase 9's commits, signed at set-up: each plane's groups of
    COALESCE_GROUPS and ed25519's eight 150-validator commits; each commit
    of one size is signed by the same validators at its own height."""
    out = {}
    height = 500
    sizes = {(n, count) for n, count, _ in COALESCE_GROUPS}
    for kind in PLANES:
        seeds, pubs = keys[kind]
        for n, count in sorted(sizes | ({(150, 8)} if kind == "ed25519" else set())):
            out[kind, n] = [build_commit(pool, kind, seeds, pubs, rng, n, chain_id, height + i)
                            for i in range(count)]
            height += count
    return out


def commit_outcome(chain_id, entry):
    """verify_commit's verdict: "accepted", or its error up to the
    signature's hex."""
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, bid, commit = entry
    try:
        verify_commit(chain_id, vals, bid, commit.height, commit)
    except ValueError as e:
        return str(e).split(":")[0]
    return "accepted"


def one_launch(P, pks, rows: int, valid: bool):
    """The launches one direct call over `rows` rows of these keys makes
    now: none below the device cutover; the cache hit (and the fill, when a
    key is not in the cache) below the RLC cutover; the RLC, and on a bad
    row the cache hit (and fill) after it, above."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    if rows < ed.DEVICE_BATCH_CUTOVER:
        return {}
    cache = P.cache()
    bitmap = {P.hit.__name__: 1}
    if any(pk not in cache._lru for pk in set(pks)):
        bitmap[P.fill.__name__] = 1
    if rows < ed.MSM_BATCH_CUTOVER:
        return bitmap
    return {P.rlc.__name__: 1, **({} if valid else bitmap)}


def coalesced_on_card(kind, calls):
    """Each call in a thread of its own while the engine's dispatch worker
    is held by a first, one-row job, so that the calls' jobs all queue
    before the worker takes its next group. Launch counts are set to 0 just
    before the release and read after the last call returns. Returns (each
    call's output, the launches, the groups the release formed as
    (observations, jobs) of coalesced_group_size)."""
    import threading

    import torch

    from tendermint_tpu_torch.metrics import engine_metrics
    from tendermint_tpu_torch.ops import engine as E

    eng = E.get_engine()
    gate, held = threading.Event(), threading.Event()
    dispatch_group = eng._dispatch_group

    def hold(group, seq=0):
        del eng._dispatch_group  # only this first group waits
        held.set()
        if not gate.wait(120):
            raise AssertionError("phase 9: the held group was never released")
        return dispatch_group(group, seq)

    eng._dispatch_group = hold
    blocker = eng.submit(kind, [bytes(32)], [b"hold"], [bytes(64)])  # one host row
    if not held.wait(60):
        raise AssertionError("phase 9: the dispatch worker never took the first job")
    outs, errors = {}, []

    def run(i, fn):
        try:
            outs[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while len(eng._pending) < len(calls) and not errors:
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 9: {len(eng._pending)} of {len(calls)} jobs queued")
        time.sleep(0.001)
    groups = engine_metrics().coalesced_group_size
    (_, jobs0, n0), = groups.totals()  # the holding group is observed already
    reset_counts()
    gate.set()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"phase 9: a caller failed or hung: {errors}")
    torch.cuda.synchronize()
    launches = {name: c for name, c in read_counts().items() if c}
    (_, jobs1, n1), = groups.totals()
    blocker.result(timeout=60)
    return [outs[i] for i in range(len(calls))], launches, (int(n1 - n0), int(jobs1 - jobs0))


def coalescing_phase(planes, chain_id, commits9):
    """Phase 9 (a) and (b) on each plane: the groups of COALESCE_GROUPS, each
    submitted behind a held worker, must form one group, give each caller
    the verdict and tampered index that direct dispatch gives it and launch
    exactly what one direct call over the combined rows launches; three
    20-signature jobs (60 rows, below the cutover) form one host group and
    launch nothing."""
    from tendermint_tpu_torch.crypto.batch import create_batch_verifier
    from tendermint_tpu_torch.metrics import engine_metrics

    for kind, P in planes.items():
        for n, count, bad_commit in COALESCE_GROUPS:
            entries = commits9[kind, n]
            bad = (n * 5) // 12
            good = entries[bad_commit][2].signatures[bad].signature if bad_commit is not None else None
            if bad_commit is not None:
                entries[bad_commit][2].signatures[bad].signature = tamper(good)
            try:
                with env_setting("TM_TPU_ENGINE", "off"):
                    want = [commit_outcome(chain_id, e) for e in entries]
                expect = one_launch(P, [v.pub_key.bytes() for v in entries[0][0].validators],
                                    n * count, bad_commit is None)
                got, launches, groups = coalesced_on_card(
                    kind, [functools.partial(commit_outcome, chain_id, e) for e in entries])
            finally:
                if bad_commit is not None:
                    entries[bad_commit][2].signatures[bad].signature = good
            verdicts = ["accepted"] * count
            if bad_commit is not None:
                verdicts[bad_commit] = f"wrong signature (#{bad})"
            if got != want or want != verdicts:
                raise AssertionError(f"phase 9: {kind} {count} x {n}: engine {got}, direct {want}, "
                                     f"expected {verdicts}")
            if groups != (1, count) or launches != expect:
                raise AssertionError(f"phase 9: {kind} {count} x {n}: groups {groups}, launched "
                                     f"{launches}, one launch over {n * count} rows makes {expect}")
            log(f"phase 9: {kind} {count} x {n}-validator commits as one group of {n * count} rows: "
                f"verdicts {got} (direct dispatch's), launches {json.dumps(launches)}")

        vals, _, commit = commits9[kind, COALESCE_GROUPS[0][0]][0]
        calls = []
        for j in range(3):
            bv = create_batch_verifier(vals.validators[0].pub_key)
            for i in range(20 * j, 20 * j + 20):
                bv.add(vals.validators[i].pub_key, commit.vote_sign_bytes(chain_id, i),
                       commit.signatures[i].signature)
            calls.append(bv.verify)
        def host_groups():
            samples = engine_metrics().launches.samples()
            return {tuple(lb.values()): v for _, lb, v in samples}.get((kind, "host"), 0)

        before = host_groups()
        got, launches, groups = coalesced_on_card(kind, calls)
        deadline = time.monotonic() + 5  # a group is counted after its callers wake
        while host_groups() - before < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        after = host_groups()
        if got != [(True, [True] * 20)] * 3 or launches or groups != (1, 3) or after - before != 2:
            raise AssertionError(f"phase 9: {kind} 3 x 20 signatures: {groups} groups, launched "
                                 f"{launches}, host groups {after - before} (with the holding one)")
        log(f"phase 9: {kind} 3 x 20 signatures as one host group of 60 rows, no launch")


# A fresh process with TM_TPU_DEVOBS=1: the valid 1,000-validator ed25519
# commit's rows (argv[2], hex JSON) through the engine, a pubkey-cache fill
# of 150 keys, a residency sample, then a build of fail_count into an empty
# build directory (argv[4]); writes devobs' status, the sample and the
# libraries loaded as JSON to argv[3].
DEVOBS_SCRIPT = r"""
import json
import os
import sys
from pathlib import Path

root, jobs_path, out, build_dir = sys.argv[1:5]
os.environ["TM_TPU_DEVOBS"] = "1"
sys.path.insert(0, root)
from tendermint_tpu_torch import devobs
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.metrics import global_registry
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import verify as V

with open(jobs_path) as f:
    pks, msgs, sigs = ([bytes.fromhex(x) for x in col] for col in json.load(f))
bv = ed.Ed25519BatchVerifier()
for p, m, s in zip(pks, msgs, sigs):
    bv.add(ed.Ed25519PubKey(p), m, s)
before = devobs.status()
ok, _ = bv.verify()
call = devobs.status()
V.pubkey_cache().ensure(pks[:150])
sample = devobs.sample_residency()
loaded = sorted(_build._LIBS)
_build.BUILD_DIR = Path(build_dir)
_build.load("fail_count")
with open(out, "w") as f:
    json.dump({"enabled": devobs.enabled(), "ok": ok, "before": before, "call": call,
               "sample": sample, "loaded": loaded, "status": devobs.status(tail=256),
               "gather": global_registry().gather()}, f)
"""


def devobs_phase(chain_id, entry, tmp):
    """Phase 9 (c): devobs on the card in a fresh process. The 1,000-row
    call's h2d bytes must equal its inputs' (the RLC's rows padded to 1,024:
    a, r, zk of 32 bytes, z of 16, and zs, 32 bytes), its d2h the verdict's
    byte; residency must be above zero after the cache fill, the cache
    plane holding the cache's tables; the build events must be one load of
    each library the process loaded and one nvcc run and one load of the
    one kernel it built."""
    pks, msgs, sigs = commit_jobs(entry, chain_id)
    jobs, out = os.path.join(tmp, "devobs_jobs.json"), os.path.join(tmp, "devobs.json")
    script, build_dir = os.path.join(tmp, "devobs.py"), os.path.join(tmp, "build")
    os.makedirs(build_dir)
    with open(jobs, "w") as f:
        json.dump([[x.hex() for x in col] for col in (pks, msgs, sigs)], f)
    with open(script, "w") as f:
        f.write(DEVOBS_SCRIPT)
    proc = run_process([sys.executable, script, ROOT, jobs, out, build_dir], 600, "phase 9 (c)", check=False,
                       cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"phase 9 (c) failed (rc {proc.returncode}):\n{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    n = len(sigs)
    rows = 1 << (n - 1).bit_length()
    want_h2d = rows * (32 + 32 + 32 + 16) + 32
    h2d = res["call"]["transfer_bytes"]["h2d"] - res["before"]["transfer_bytes"]["h2d"]
    d2h = res["call"]["transfer_bytes"]["d2h"] - res["before"]["transfer_bytes"]["d2h"]
    if not (res["enabled"] and res["ok"]) or (h2d, d2h) != (want_h2d, 1):
        raise AssertionError(f"phase 9 (c): the {n}-row call copied {h2d} bytes in and {d2h} out, "
                             f"its inputs take {want_h2d} and 1: {json.dumps(res['call'])}")
    sample = res["sample"]
    plane = sample["planes"].get("ed25519_pk", {})
    if sample["live_buffer_bytes"] <= 0 or plane.get("entries", 0) < 150 or plane.get("bytes", 0) <= 0:
        raise AssertionError(f"phase 9 (c): residency after the fill: {json.dumps(sample)}")
    events = sorted((e["fn"], e["kind"]) for e in res["status"]["tail"])
    want_events = sorted([(lib, "load") for lib in res["loaded"]] + [("fail_count", "nvcc"),
                                                                     ("fail_count", "load")])
    if events != want_events or res["status"]["compiles"] != len(want_events):
        raise AssertionError(f"phase 9 (c): build events {events}, expected {want_events}")
    log(f"phase 9: devobs: the valid {n}-validator call copied {h2d} bytes to the card (its inputs, "
        f"{rows} rows) and {d2h} back; after a 150-key cache fill {sample['live_buffer_bytes']} bytes "
        f"live, high water {sample['high_water_bytes']}, planes {json.dumps(sample['planes'])}; build "
        f"events {json.dumps(events)} in "
        f"{sum(e['dur_s'] for e in res['status']['tail']):.3f} s on {card()}")
    return res


def concurrent_turns(what, entries, chain_id, runs):
    """Phase 9 (d): len(entries) verify_commit callers, one thread each,
    released together, engine against direct dispatch in ENGINE_TURNS; the
    wall time of a turn runs from the release to the last return (then a
    synchronize). Logs and returns each mode's mean seconds and launches per
    commit, and the engine's overlap_ratio; logs the engine turns' groups
    and their mean queue wait, launch (dispatch stage) and collect latency
    from EngineMetrics."""
    import threading

    import torch

    from tendermint_tpu_torch.metrics import engine_metrics

    m = engine_metrics()
    stages = {"queue_wait": m.queue_wait, "launch": m.launch_latency, "collect": m.collect_latency}

    def stage_totals():
        return {k: tuple(sum(t[i] for t in h.totals()) for i in (1, 2)) for k, h in stages.items()}

    times = {"direct": [], "engine": []}
    launches = {"direct": [], "engine": []}
    stage_sums = {k: [0.0, 0.0] for k in stages}
    for mode in ENGINE_TURNS:
        before = stage_totals()
        with env_setting("TM_TPU_ENGINE", "off" if mode == "direct" else None):
            start = threading.Barrier(len(entries) + 1)
            outs = []

            def call(entry, start=start, outs=outs):
                start.wait(timeout=60)
                outs.append(commit_outcome(chain_id, entry))

            threads = [threading.Thread(target=call, args=(e,)) for e in entries]
            for t in threads:
                t.start()
            torch.cuda.synchronize()
            reset_counts()
            start.wait(timeout=60)
            t0 = time.perf_counter()
            for t in threads:
                t.join(timeout=300)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or outs != ["accepted"] * len(entries):
            raise AssertionError(f"phase 9: {what} ({mode}): {outs}")
        times[mode].append(t)
        launches[mode].append(sum(read_counts().values()) / len(entries))
        if mode == "engine":
            for k, (total, count) in stage_totals().items():
                stage_sums[k][0] += total - before[k][0]
                stage_sums[k][1] += count - before[k][1]
    ratio = next((v for _, _, v in m.overlap_ratio.samples()), 0.0)
    groups = int(stage_sums["launch"][1])
    stage_ms = {k: round(total / count * 1e3, 3) if count else None
                for k, (total, count) in stage_sums.items()}
    mean = {mode: sum(v) / len(v) for mode, v in times.items()}
    per = {mode: sum(v) / len(v) for mode, v in launches.items()}
    log(f"phase 9: {what}: engine {mean['engine'] * 1e3:.2f} ms, direct {mean['direct'] * 1e3:.2f} ms "
        f"(means of the turns {ENGINE_TURNS}; each turn "
        f"{json.dumps({m: [round(x * 1e3, 2) for x in v] for m, v in times.items()})} ms), launches a "
        f"commit engine {per['engine']:.3f} direct {per['direct']:.3f}, overlap_ratio {ratio:.4f}; "
        f"the engine turns' {groups} groups, mean ms a group {json.dumps(stage_ms)} on {card()}")
    for mode in times:
        runs.append({"plane": "ed25519", "commit": len(entries[0][0].validators),
                     "run": f"{what}, {mode}, mean of {ENGINE_TURNS.count(mode)}", "s": mean[mode],
                     "launches_per_commit": per[mode]})
    return mean, per, ratio


def engine_phase(planes, chain_id, commits, commits9, runs, tmp):
    """Phase 9: the engine on the card, (a) to (d)."""
    coalescing_phase(planes, chain_id, commits9)
    devobs_phase(chain_id, commits["ed25519"][SIZES[1]], tmp)
    for n, threads in CALLER_MIXES:
        concurrent_turns(f"{threads} threads x {n}-validator ed25519 commits", commits9["ed25519", n][:threads],
                         chain_id, runs)
    n = SIZES[-1]
    concurrent_turns(f"one {n}-validator ed25519 call", [commits["ed25519"][n]], chain_id, runs)


# -- phase 10: the light client and the hashes on the card ---------------------------

LIGHT_VALIDATORS = 150  # the Cosmos Hub's active set
LIGHT_HEIGHTS = 16
LIGHT_SWAP_AT = 9  # the first height the second set signs
LIGHT_T0 = 1_700_000_000  # the first header's time, unix seconds
LIGHT_DT = 6  # seconds between headers
TRUSTING_PERIOD_NS = 14 * 24 * 3600 * 10**9
MAX_CLOCK_DRIFT_NS = 10 * 10**9
MIXED_SECP = 50  # BASELINE.json config 4's secp256k1 keys among 150
MULTIPROOF_INDICES = 64
HASH_TURNS = ("native", "python", "python", "native")


def light_modules():
    """The port's modules a light chain is built and verified with; the
    builders below take such a namespace, so the CPU tests can hand them
    the JAX package's instead."""
    from tendermint_tpu_torch import light
    from tendermint_tpu_torch.crypto import ed25519, merkle, secp256k1, sr25519
    from tendermint_tpu_torch.evidence import verify as ev
    from tendermint_tpu_torch.light import client
    from tendermint_tpu_torch.store import kv
    from tendermint_tpu_torch.types import block, evidence, light_block, validation, validator_set, vote
    from tendermint_tpu_torch.utils import tmtime

    return SimpleNamespace(
        light=light, block=block, light_block=light_block, validation=validation, vs=validator_set,
        tmtime=tmtime, merkle=merkle, client=client, kv=kv, vote=vote, evidence=evidence, ev=ev,
        keys={"ed25519": ed25519.Ed25519PubKey, "sr25519": sr25519.Sr25519PubKey,
              "secp256k1": secp256k1.Secp256k1PubKey})


def light_vals(m, members, proposer: int | None = None):
    """A validator set over members [(kind, pub, secret)] of power 10 each,
    the member at index `proposer` 11 (so that it proposes); returns the set
    and each address's secret."""
    vals, secrets = [], {}
    for i, (kind, pub, secret) in enumerate(members):
        v = m.vs.Validator.new(m.keys[kind](pub), 11 if i == proposer else 10)
        vals.append(v)
        secrets[v.address] = secret
    return m.vs.ValidatorSet.new(vals), secrets


def signed_commit(m, vals, secrets, sign, chain_id, height, block_id, time_s):
    """A commit of every validator of vals for block_id, each signing its
    canonical vote sign bytes through sign(secrets, msgs) -> sigs."""
    commit = m.block.Commit(height=height, round=0, block_id=block_id, signatures=[
        m.block.CommitSig.new_commit(v.address, m.tmtime.Time(time_s + 1, 1000 * i + 7), b"")
        for i, v in enumerate(vals.validators)])
    msgs = [commit.vote_sign_bytes(chain_id, i) for i in range(len(vals.validators))]
    for cs, sig in zip(commit.signatures, sign([secrets[v.address] for v in vals.validators], msgs)):
        cs.signature = sig
    return commit


def tagged(tag: bytes, height: int) -> bytes:
    """A made-up 32-byte hash for a header field."""
    import hashlib

    return hashlib.sha256(b"%s-%d" % (tag, height)).digest()


def signed_header(m, vals, next_vals, secrets, sign, chain_id, height, last_block_id, last_commit_hash):
    """A fully populated header at `height` signed by vals: its commit signs
    header.hash()."""
    sha = lambda tag: tagged(tag, height)
    time_s = LIGHT_T0 + LIGHT_DT * height
    header = m.block.Header(
        chain_id=chain_id, height=height, time=m.tmtime.Time(time_s, 1000 * height),
        last_block_id=last_block_id, last_commit_hash=last_commit_hash,
        data_hash=m.block.txs_hash([b"tx-%d-%d" % (height, i) for i in range(3)]),
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        consensus_hash=sha(b"consensus"), app_hash=sha(b"app"), last_results_hash=sha(b"results"),
        evidence_hash=m.merkle.hash_from_byte_slices([]),
        proposer_address=vals.get_proposer().address)
    block_id = m.block.BlockID(header.hash(), m.block.PartSetHeader(1, sha(b"parts")))
    return m.light_block.SignedHeader(
        header, signed_commit(m, vals, secrets, sign, chain_id, height, block_id, time_s))


def light_chain(m, members, swap_in, untrusted, sign, chain_id, heights=LIGHT_HEIGHTS,
                swap_at=(LIGHT_SWAP_AT,)):
    """A chain of `heights` light blocks over members' set A whose set changes
    at each height of swap_at: at the i-th, the next k = len(swap_in) //
    len(swap_at) of A's validators (in A's order) leave and the next k of
    swap_in join (update_with_change_set, then the proposer rotation). With
    `untrusted` given, also a rival block at the last height signed by set C:
    a third of A's members and the `untrusted` members, where A's validators
    hold a third of A's power. Returns ({height: LightBlock}, the rival
    LightBlock or None)."""
    a, secrets = light_vals(m, members)
    k = len(swap_in) // len(swap_at)
    sets, current = [], a
    for i in range(len(swap_at)):
        changes = [m.vs.Validator(v.address, v.pub_key, 0) for v in a.validators[i * k:(i + 1) * k]]
        for kind, pub, secret in swap_in[i * k:(i + 1) * k]:
            new = m.vs.Validator.new(m.keys[kind](pub), 10)
            secrets[new.address] = secret
            changes.append(new)
        current = current.copy()
        current.update_with_change_set(changes)
        current = current.copy_increment_proposer_priority(1)
        sets.append(current)

    def vals_at(h):
        passed = [i for i, at in enumerate(swap_at) if h >= at]
        return sets[passed[-1]] if passed else a

    blocks = {}
    last_bid, last_commit_hash = m.block.BlockID(), b""
    for h in range(1, heights + 1):
        vals = vals_at(h)
        sh = signed_header(m, vals, vals_at(h + 1), secrets, sign, chain_id, h, last_bid, last_commit_hash)
        blocks[h] = m.light_block.LightBlock(sh, vals)
        last_bid, last_commit_hash = sh.commit.block_id, sh.commit.hash()
    if untrusted is None:
        return blocks, None
    c, c_secrets = light_vals(m, members[:len(members) // 3] + list(untrusted))
    prev = blocks[heights - 1].signed_header.commit
    rival = signed_header(m, c, c, c_secrets, sign, chain_id, heights, prev.block_id, prev.hash())
    return blocks, m.light_block.LightBlock(rival, c)


def tampered_commit(m, commit, idx):
    """A copy of commit with signature #idx tampered."""
    sigs = [m.block.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                              tamper(cs.signature) if i == idx else cs.signature)
            for i, cs in enumerate(commit.signatures)]
    return m.block.Commit(commit.height, commit.round, commit.block_id, sigs)


def light_cases(m, blocks, rival, chain_id, device=None):
    """Phase 10 (a)'s calls: [(label, call, vals whose commit check it runs
    or None, the trusting check's vals or None, expected outcome)]; an
    outcome is ("accepted", "") or (error class, a fragment of its
    message). `device` is passed on unless None (the JAX package's
    verifier takes none)."""
    import dataclasses

    L = m.light
    sh = {h: lb.signed_header for h, lb in blocks.items()}
    vals = {h: lb.validator_set for h, lb in blocks.items()}
    top = max(blocks)
    now = m.tmtime.Time(LIGHT_T0 + LIGHT_DT * top + 60)
    period, drift = TRUSTING_PERIOD_NS, MAX_CLOCK_DRIFT_NS
    ok = ("accepted", "")
    kw = {} if device is None else {"device": device}
    cases = [(f"verify_adjacent {h} -> {h + 1}",
              functools.partial(L.verify_adjacent, chain_id, sh[h], sh[h + 1], vals[h + 1], period,
                                now, drift, **kw), vals[h + 1], None, ok)
             for h in range(1, top)]
    cases.append((f"verify_non_adjacent 1 -> {top}", functools.partial(
        L.verify_non_adjacent, chain_id, sh[1], vals[1], sh[top], vals[top], period, now, drift,
        **kw), vals[top], vals[1], ok))
    cases.append((f"verify 1 -> {top}", functools.partial(
        L.verify, chain_id, sh[1], vals[1], sh[top], vals[top], period, now, drift, **kw),
        vals[top], vals[1], ok))
    s = min(h for h in blocks if vals[h].hash() != vals[1].hash())  # the first height of the new set
    forged = m.light_block.SignedHeader(dataclasses.replace(sh[s].header, data_hash=bytes(32)),
                                        sh[s].commit)
    cases.append((f"forged data_hash at {s}", functools.partial(
        L.verify_adjacent, chain_id, sh[s - 1], forged, vals[s], period, now, drift, **kw),
        None, None, ("ErrInvalidHeader", "commit signs block")))
    cases.append((f"the old set supplied at {s}", functools.partial(
        L.verify_adjacent, chain_id, sh[s - 1], sh[s], vals[s - 1], period, now, drift, **kw),
        None, None, ("ErrInvalidHeader", "to match those that were supplied")))
    bad = (len(vals[top].validators) * 5) // 12
    tampered = m.light_block.SignedHeader(sh[top].header, tampered_commit(m, sh[top].commit, bad))
    cases.append((f"signature #{bad} tampered at {top}", functools.partial(
        L.verify_adjacent, chain_id, sh[top - 1], tampered, vals[top], period, now, drift,
        **kw), vals[top], None, ("ErrInvalidHeader", f"wrong signature (#{bad})")))
    late = now.add(TRUSTING_PERIOD_NS)
    cases.append(("trusted header expired", functools.partial(
        L.verify_adjacent, chain_id, sh[1], sh[2], vals[2], period, late, drift, **kw),
        None, None, ("ErrOldHeaderExpired", "old header expired")))
    cases.append((f"a third of the trusted power at {top}", functools.partial(
        L.verify_non_adjacent, chain_id, sh[1], vals[1], rival.signed_header, rival.validator_set,
        period, now, drift, **kw), None, vals[1], (
            "ErrNewValSetCantBeTrusted", "insufficient voting power")))
    return cases


def error_name(e):
    """An error's class name as the JAX package gives it: the port's
    CommitVerificationError (types/validation.py) is the ValueError that the
    JAX package raises for a commit that does not verify."""
    return "ValueError" if type(e).__name__ == "CommitVerificationError" else type(e).__name__


def outcome(call):
    """("accepted", "") or (the error's class name, its message)."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return error_name(e), str(e)
    return "accepted", ""


def light_counted(vals, frac=(2, 3)):
    """The keys a commit check of vals tallies before its power passes
    frac of the total (every validator signed, in the set's order)."""
    needed = vals.total_voting_power() * frac[0] // frac[1]
    tallied, keys = 0, []
    for v in vals.validators:
        keys.append(v.pub_key.bytes())
        tallied += v.voting_power
        if tallied > needed:
            break
    return keys


def light_setup(pool, rng, chain_id):
    """Phase 10's chains and commits, signed at set-up: a light chain on each
    plane, and the mixed-key sets of BASELINE.json config 4 with an ed25519
    and with a secp256k1 proposer, each with its signed commit."""
    m = light_modules()

    def sign(secrets, msgs):
        return [sigs[0] for _, sigs in pool.map(
            _sign_worker, [(kind, seed, [msg]) for (kind, seed), msg in zip(secrets, msgs)],
            chunksize=16)]

    def members(kind, n):
        seeds = [rng.bytes(32) for _ in range(n)]
        pubs = make_keys(pool, kind, seeds)
        return [(kind, pub, (kind, seed)) for pub, seed in zip(pubs, seeds)]

    n = LIGHT_VALIDATORS
    chains = {}
    for kind in PLANES:
        fresh = members(kind, n + 1 + n - n // 3)
        chains[kind] = light_chain(m, fresh[:n], [fresh[n]], fresh[n + 1:], sign, chain_id)
    mixed = members("ed25519", n - MIXED_SECP) + members("secp256k1", MIXED_SECP)
    order = rng.permutation(n)
    mixed = [mixed[i] for i in order]
    sets = {}
    for proposer_kind in ("ed25519", "secp256k1"):
        vals, secrets = light_vals(m, mixed, [k for k, _, _ in mixed].index(proposer_kind))
        bid = m.block.BlockID(rng.bytes(32), m.block.PartSetHeader(1, rng.bytes(32)))
        sets[proposer_kind] = vals, bid, signed_commit(m, vals, secrets, sign, chain_id, 900, bid,
                                                       LIGHT_T0)
    return chains, sets


def light_phase(planes, chain_id, chains, runs):
    """Phase 10 (a) on each plane: every call of light_cases with its launch
    counters zeroed just before it and read just after, held to the
    launches its routing gives; returns the launches summed."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    m = light_modules()
    totals = {}
    for kind, P in planes.items():
        blocks, rival = chains[kind]
        seen = set()
        plane_totals = {}
        for label, call, checked, trusted, want in light_cases(m, blocks, rival, chain_id):
            if trusted is not None and len(light_counted(trusted, (1, 3))) >= ed.DEVICE_BATCH_CUTOVER:
                raise AssertionError(f"phase 10: {label}: the trusting check would reach the card")
            expect = {}
            if checked is not None:
                keys = light_counted(checked)
                if len(keys) >= ed.DEVICE_BATCH_CUTOVER:
                    expect = {P.hit.__name__: 1}
                    if not seen.issuperset(keys):
                        expect[P.fill.__name__] = 1
                    seen.update(keys)
            got, t = drive(f"phase 10: {kind} {label}", lambda: outcome(call), expect, plane_totals)
            if got[0] != want[0] or want[1] not in got[1]:
                raise AssertionError(f"phase 10: {kind} {label}: {got}, expected {want}")
            runs.append({"plane": kind, "commit": len(blocks[1].validator_set.validators),
                         "run": f"light {label}", "s": t})
            log(f"phase 10: {kind} {label}: {got[0]}{' (' + got[1][:60] + ')' if got[1] else ''}, "
                f"launches {json.dumps(expect)}, {t * 1e3:.2f} ms on {card()}")
        fills, hits = plane_totals.get(P.fill.__name__, 0), plane_totals.get(P.hit.__name__, 0)
        if not fills or not hits:
            raise AssertionError(f"phase 10: {kind} launched {plane_totals}: a fill and a hit expected")
        for name, c in plane_totals.items():
            totals[name] = totals.get(name, 0) + c
    check_path("phase 10", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()])
    return totals


def hash_phase(vals, runs):
    """Phase 10 (b): a 10,000-validator set's hash() cold (a copy without the
    leaf memo) and memoized; its leaves' root, proofs and a 64-index
    multiproof on the native route and under TM_TPU_NATIVE=0 in turns
    HASH_TURNS, the same bytes on both, each proof verifying and a tampered
    one failing. No call launches a kernel."""
    import numpy as np

    m = light_modules()
    n = len(vals.validators)
    cold = m.vs.ValidatorSet(
        validators=[m.vs.Validator(v.address, v.pub_key, v.voting_power, v.proposer_priority)
                    for v in vals.validators], proposer=vals.proposer)
    totals = {}
    root, t_cold = drive("phase 10: cold hash()", cold.hash, {}, totals)
    again, t_memo = drive("phase 10: memoized hash()", cold.hash, {}, totals)
    leaves = [v.bytes() for v in cold.validators]
    idx = sorted(np.random.default_rng(n).choice(n, MULTIPROOF_INDICES, replace=False).tolist())
    got, times = {}, {route: {"root": [], "proofs": [], "multiproof": []} for route in HASH_TURNS}
    for route in HASH_TURNS:
        with native_setting(route == "python"):
            r, t = drive("phase 10: root", lambda: m.merkle.hash_from_byte_slices(leaves), {}, totals)
            times[route]["root"].append(t)
            (pr, proofs), t = drive("phase 10: proofs",
                                    lambda: m.merkle.proofs_from_byte_slices(leaves), {}, totals)
            times[route]["proofs"].append(t)
            (mr, mp), t = drive("phase 10: multiproof",
                                lambda: m.merkle.multiproof_from_byte_slices(leaves, idx), {}, totals)
            times[route]["multiproof"].append(t)
        this = (r, pr, [(p.leaf_hash, p.aunts) for p in proofs], mr, mp.leaf_hashes, mp.nodes)
        if got.setdefault(route, this) != this or got[HASH_TURNS[0]] != this:
            raise AssertionError(f"phase 10: the {route} route's hashes differ")
    if not (root == again == got["native"][0] and all(
            p.verify(root, leaf) for p, leaf in zip(proofs, leaves)) and mp.verify(
            root, [leaves[i] for i in idx])):
        raise AssertionError("phase 10: the 10,000-validator hashes or proofs do not verify")
    forged = m.merkle.Proof(n, 7, proofs[7].leaf_hash, [bytes(32)] + proofs[7].aunts[1:])
    if forged.verify(root, leaves[7]) or mp.verify(root, [leaves[idx[0]] + b"x"] + [
            leaves[i] for i in idx[1:]]):
        raise AssertionError("phase 10: a tampered proof verified")
    mean = {route: {k: float(np.mean(v)) for k, v in parts.items()} for route, parts in times.items()}
    runs.append({"plane": "ed25519", "commit": n, "run": "validator-set hash() cold", "s": t_cold})
    runs.append({"plane": "ed25519", "commit": n, "run": "validator-set hash() memoized", "s": t_memo})
    log(f"phase 10: {n}-validator set hash() cold {t_cold * 1e3:.3f} ms (leaf encodes and a native "
        f"root), memoized {t_memo * 1e6:.2f} us; root, {n} proofs, a {MULTIPROOF_INDICES}-index "
        f"multiproof, ms (means of turns {'/'.join(HASH_TURNS)}): "
        + json.dumps({r: {k: round(v * 1e3, 4) for k, v in parts.items()} for r, parts in mean.items()})
        + f"; the same bytes on both routes, every proof verifies, on {card()}")


def mixed_phase(chain_id, sets, runs):
    """Phase 10 (c), BASELINE.json config 4: verify_commit on the mixed-key
    commits (50 secp256k1 keys among 150) under each proposer: the valid
    commit accepted, a tampered secp256k1 and a tampered ed25519 signature
    reported at their index, by the reference's serial semantics, so no
    call launches a kernel."""
    from tendermint_tpu_torch.crypto import secp256k1

    m = light_modules()
    totals = {}
    for proposer_kind, (vals, bid, commit) in sets.items():
        kinds = [v.pub_key.type_name for v in vals.validators]
        proposer = vals.get_proposer().pub_key.type_name
        if proposer != proposer_kind or kinds.count("secp256k1") != MIXED_SECP:
            raise AssertionError(f"phase 10: the mixed set has a {proposer} proposer, {kinds.count('secp256k1')} "
                                 "secp256k1 keys")
        for label, bad in (("valid", None), ("secp256k1 tampered", kinds.index("secp256k1", 1)),
                           ("ed25519 tampered", kinds.index("ed25519", 1))):
            c = commit if bad is None else tampered_commit(m, commit, bad)
            got, t = drive(f"phase 10: mixed {label}", lambda: outcome(functools.partial(
                m.validation.verify_commit, chain_id, vals, bid, c.height, c)), {}, totals)
            want = "accepted" if bad is None else f"wrong signature (#{bad}):"
            if not (got[0] if bad is None else got[1]).startswith(want):
                raise AssertionError(f"phase 10: mixed {label} under a {proposer} proposer: {got}")
            runs.append({"plane": "mixed", "commit": len(kinds), "run": f"verify_commit {label}, "
                         f"{proposer} proposer", "s": t})
            log(f"phase 10: mixed-key verify_commit ({len(kinds) - MIXED_SECP} ed25519 + {MIXED_SECP} "
                f"secp256k1, {proposer} proposer) {label}: {got[0]}{' #' + str(bad) if bad is not None else ''}, "
                f"no launch, {t * 1e3:.1f} ms, secp256k1 route {secp256k1.route()}, on {card()}")


# -- phase 11: the light client, its store and providers, and evidence ---------------

ROTATION_HEIGHTS = 32
ROTATION_SWAPS = (9, 17, 25)  # a third of the set leaves at each: none of it signs 32
BACKWARDS_TO = 20
# the reference's EvidenceParams defaults (types/params.py:48-51)
EVIDENCE_PARAMS = {"max_age_num_blocks": 100000, "max_age_duration": 48 * 3600 * 10**9,
                   "max_bytes": 1048576}
FORGED_APP_HASH = b"\x66" * 32


def member_secrets(m, members):
    """Each member's address and secret."""
    return {m.keys[kind](pub).address(): secret for kind, pub, secret in members}


def resign(m, vals, secrets, sign, chain_id, header, **changes):
    """A LightBlock of vals over a copy of header with `changes`, its commit
    signed by every validator of vals."""
    import dataclasses

    header = dataclasses.replace(header, **changes)
    bid = m.block.BlockID(header.hash(), m.block.PartSetHeader(1, tagged(b"forged parts", header.height)))
    commit = signed_commit(m, vals, secrets, sign, chain_id, header.height, bid,
                           LIGHT_T0 + LIGHT_DT * header.height)
    return m.light_block.LightBlock(m.light_block.SignedHeader(header, commit), vals)


def rotation_chain(m, members, swap_in, sign, chain_id, heights=ROTATION_HEIGHTS, swap_at=ROTATION_SWAPS):
    """Phase 11's chain: light_chain with a third of the set swapped at each
    height of swap_at; the lunatic witness's block at the last height (the
    set of height 1, the common set, re-signs the header with a forged
    app_hash and itself as the validators), the equivocating witness's (the
    height's own set signs it again, same round, with another data_hash),
    and two precommits of one validator at the last height for two block
    IDs."""
    blocks, _ = light_chain(m, members, swap_in, None, sign, chain_id, heights, swap_at)
    secrets = member_secrets(m, list(members) + list(swap_in))
    header = blocks[heights].signed_header.header
    common, last = blocks[1].validator_set, blocks[heights].validator_set
    lunatic = resign(m, common, secrets, sign, chain_id, header, app_hash=FORGED_APP_HASH,
                     validators_hash=common.hash(), next_validators_hash=common.hash(),
                     proposer_address=common.get_proposer().address)
    equivocation = resign(m, last, secrets, sign, chain_id, header,
                          data_hash=tagged(b"other data", heights))
    val = last.validators[0]
    votes = []
    for tag in (b"vote a", b"vote b"):
        v = m.vote.Vote(type=m.vote.PRECOMMIT, height=heights, round=0,
                        block_id=m.block.BlockID(tagged(tag, heights),
                                                 m.block.PartSetHeader(1, tagged(tag + b" parts", heights))),
                        timestamp=header.time, validator_address=val.address, validator_index=0)
        v.signature = sign([secrets[val.address]], [v.sign_bytes(chain_id)])[0]
        votes.append(v)
    return SimpleNamespace(blocks=blocks, lunatic=lunatic, equivocation=equivocation, votes=votes)


class ChainStore:
    """A stand-in for a node's block store and state store over {height:
    LightBlock}: what LocalProvider and verify_evidence read. A height's
    canonical commit is the next block's last commit, so the tip has only
    its seen commit."""

    def __init__(self, blocks):
        self.blocks = blocks

    def height(self):
        return max(self.blocks)

    def load_block_meta(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else SimpleNamespace(header=lb.signed_header.header)

    def load_block_commit(self, h):
        return self.blocks[h].signed_header.commit if h in self.blocks and h < self.height() else None

    def load_seen_commit(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else lb.signed_header.commit

    def load_validators(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else lb.validator_set


def recording_provider(m, chain_id, block_store, state_store, name):
    """A LocalProvider of m's package over the two stores, recording the
    heights it is asked for in `.fetched`."""

    class RecordingProvider(m.light.LocalProvider):
        def light_block(self, height):
            self.fetched.append(height)
            return super().light_block(height)

    provider = RecordingProvider(chain_id, block_store, state_store, name)
    provider.fetched = []
    return provider


def chain_provider(m, chain_id, blocks, name):
    """recording_provider over ChainStore(blocks)."""
    store = ChainStore(blocks)
    return recording_provider(m, chain_id, store, store, name)


def chain_state(blocks, chain_id):
    """A stand-in for a full node's state at the chain's tip."""
    top = blocks[max(blocks)].signed_header.header
    return SimpleNamespace(chain_id=chain_id, last_block_height=top.height, last_block_time=top.time,
                           consensus_params=SimpleNamespace(evidence=SimpleNamespace(**EVIDENCE_PARAMS)))


def trust_passes(trusted, target, frac=(1, 3)):
    """Whether the validators of `trusted` in `target` (every one of which
    signs) hold more than frac of trusted's power."""
    addrs = {v.address for v in target.validators}
    held = sum(v.voting_power for v in trusted.validators if v.address in addrs)
    return held > trusted.total_voting_power() * frac[0] // frac[1]


def bisection_model(blocks, lo, hi):
    """Skipping verification from lo to hi worked out from the sets alone:
    ([(trusted height, target height, passes)], the midpoints fetched)."""
    steps, mids, verified, pending = [], [], [lo], [hi]
    while pending:
        cur, cand = verified[-1], pending[-1]
        ok = cand == cur + 1 or trust_passes(blocks[cur].validator_set, blocks[cand].validator_set)
        steps.append((cur, cand, ok))
        if ok:
            verified.append(cand)
            pending.pop()
        else:
            mids.append((cur + cand) // 2)
            pending.append(mids[-1])
    return steps, mids


@contextlib.contextmanager
def traced_client(m, counts=None):
    """Routes m's light client's verifier calls through a recorder: each
    verify_adjacent / verify_non_adjacent call appends [name, trusted
    height, target height, outcome class, seconds, launches] to the yielded
    list (launches: the change of counts(), or None)."""
    real = m.client.vf
    trace = []

    def recorded(fn, trusted_at, target_at):
        def call(*a, **k):
            before = counts() if counts else None
            got = "accepted"
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            except Exception as e:
                got = type(e).__name__
                raise
            finally:
                t = time.perf_counter() - t0
                launched = None if before is None else {
                    n: c - before.get(n, 0) for n, c in counts().items() if c != before.get(n, 0)}
                trace.append([fn.__name__, a[trusted_at].header.height, a[target_at].header.height, got, t,
                              launched])
        return call

    proxy = SimpleNamespace(**{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})
    proxy.verify_adjacent = recorded(real.verify_adjacent, 1, 2)
    proxy.verify_non_adjacent = recorded(real.verify_non_adjacent, 1, 3)
    m.client.vf = proxy
    try:
        yield trace
    finally:
        m.client.vf = real


def stored_heights(store):
    """The heights a MemLightStore or DBLightStore holds, ascending (from its
    keys, without decoding a block)."""
    return sorted(store._blocks) if hasattr(store, "_blocks") else sorted(store._heights())


def client_script(m, chain, chain_id, stores=("mem", "db"), backwards_to=BACKWARDS_TO, device=None,
                  counts=None):
    """Phase 11's calls on m's package, in order, as a generator: it yields
    (label, call, the validator sets whose 2/3 commit checks the call runs,
    the expected outcome) and is sent each call's outcome ("accepted", "")
    or (error class, message); it checks what each call fetched, persisted,
    reported and built, and returns {"facts": what the CPU tests compare
    across packages, "trace": the verifier calls [name, from, to, outcome,
    seconds, launches], "times": {the detections' seconds}}.

    (a) From trust at height 1, verify to the last height skipping (the
    bisection worked out by bisection_model), sequentially, and backwards
    from the last height to backwards_to (a hash-chain walk, no commit
    check), once over a MemLightStore and once over DBLightStore(MemDB());
    (b) skipping with an honest, a lunatic and an equivocating witness:
    each lying witness raises ErrLightClientAttack, leaves only the trust
    root persisted and reports its evidence to both providers; (c) the full
    node's verify_evidence over ChainStore and chain_state: both pieces of
    evidence and a duplicate vote accepted, then the refusals."""
    import copy

    L, blocks = m.light, chain.blocks
    top = max(blocks)
    kw = {} if device is None else {"device": device}
    now = m.tmtime.Time(LIGHT_T0 + LIGHT_DT * top + 60)
    ok = ("accepted", "")
    facts, times, held = {}, {}, {}
    steps, mids = bisection_model(blocks, 1, top)
    skipped = [blocks[to].validator_set for _, to, passes in steps if passes]
    sequential = [blocks[h].validator_set for h in range(2, top + 1)]
    want_trace = {"skipping": [["verify_adjacent" if to == cur + 1 else "verify_non_adjacent", cur, to,
                                "accepted" if passes else "ErrNewValSetCantBeTrusted"]
                               for cur, to, passes in steps],
                  "sequential": [["verify_adjacent", h - 1, h, "accepted"] for h in range(2, top + 1)]}
    want_heights = {"skipping": [1] + [to for _, to, passes in steps if passes],
                    "sequential": list(range(1, top + 1)), "backwards": [backwards_to, top]}
    want_fetched = {"skipping": [1, top] + mids, "sequential": [1, top] + list(range(2, top)),
                    "backwards": list(range(top, backwards_to - 1, -1))}

    def expect(what, got, want):
        if got != want:
            raise AssertionError(f"phase 11: {what}: {got}, expected {want}")

    def client(name, trusted_at, store, mode=m.client.SKIPPING, witnesses=()):
        primary = chain_provider(m, chain_id, blocks, "primary")
        options = L.TrustOptions(period_ns=TRUSTING_PERIOD_NS, height=trusted_at,
                                 hash=blocks[trusted_at].signed_header.hash())

        def call():
            held[name] = L.LightClient(chain_id, options, primary, witnesses=list(witnesses),
                                       trusted_store=store, verification_mode=mode, clock=lambda: now, **kw)
        return primary, call

    with traced_client(m, counts) as trace:
        # (a) the three modes, over each store
        for kind in stores:
            for mode in ("skipping", "sequential", "backwards"):
                db = m.kv.MemDB() if kind == "db" else None
                store = L.MemLightStore() if db is None else L.DBLightStore(db)
                trusted_at = top if mode == "backwards" else 1
                primary, make = client(mode, trusted_at, store,
                                       m.client.SEQUENTIAL if mode == "sequential" else m.client.SKIPPING)
                yield (f"{kind} store, {mode}: trust height {trusted_at}", make,
                       [blocks[trusted_at].validator_set], ok)
                target = backwards_to if mode == "backwards" else top
                first = len(trace)
                yield (f"{kind} store, {mode}: verify to {target}",
                       functools.partial(held[mode].verify_light_block_at_height, target),
                       {"skipping": skipped, "sequential": sequential, "backwards": []}[mode], ok)
                expect(f"{kind} {mode} verifier calls", [t[:4] for t in trace[first:]], want_trace.get(mode, []))
                expect(f"{kind} {mode} persisted", stored_heights(store), want_heights[mode])
                expect(f"{kind} {mode} fetched", primary.fetched, want_fetched[mode])
                facts[f"{kind} {mode}"] = (stored_heights(store), primary.fetched,
                                           [t[:4] for t in trace[first:]])
                if db is not None:
                    facts[f"{kind} {mode} kv"] = list(db.iterator())

        # (b) witnesses
        evidence = {}
        for name, forged in (("honest", None), ("lunatic", chain.lunatic), ("equivocation", chain.equivocation)):
            served = blocks if forged is None else {**blocks, top: forged}
            witness = chain_provider(m, chain_id, served, f"{name} witness")
            store = L.MemLightStore()
            primary, make = client(name, 1, store, witnesses=[witness])
            yield f"{name} witness: trust height 1", make, [blocks[1].validator_set], ok
            c = held[name]
            detect = c._detect_divergence

            def timed_detect(*a, _detect=detect, _name=name):
                t0 = time.perf_counter()
                try:
                    return _detect(*a)
                finally:
                    times[f"detection, {_name} witness"] = time.perf_counter() - t0

            c._detect_divergence = timed_detect
            want = ok if forged is None else ("ErrLightClientAttack", f"witness {name} witness has a different header")
            yield (f"{name} witness: verify to {top}", functools.partial(c.verify_light_block_at_height, top),
                   skipped, want)
            ev = c.latest_attack_evidence
            if forged is None:
                expect("honest witness: evidence", ev, None)
                expect("honest witness: persisted", stored_heights(store), want_heights["skipping"])
                continue
            expect(f"{name} witness: persisted", stored_heights(store), [1])
            expect(f"{name} witness: reports", (primary.evidence, witness.evidence), ([ev], [ev]))
            common = 1 if name == "lunatic" else top
            byzantine = blocks[common].validator_set if name == "lunatic" else blocks[top].validator_set
            expect(f"{name} evidence", (ev.common_height, ev.total_voting_power, sorted(
                v.address for v in ev.byzantine_validators)), (common, byzantine.total_voting_power(), sorted(
                    v.address for v in byzantine.validators)))
            facts[f"{name} evidence"] = (ev.to_proto().encode(), ev.hash(), stored_heights(store))
            evidence[name] = ev

        # (c) the full node's side
        node, state = ChainStore(blocks), chain_state(blocks, chain_id)
        V = m.ev
        verify = lambda e: functools.partial(V.verify_evidence, e, state, node, node, **kw)
        last = blocks[top].validator_set
        dup = m.evidence.DuplicateVoteEvidence.new(*chain.votes, blocks[top].signed_header.header.time, last)
        facts["duplicate vote evidence"] = (dup.to_proto().encode(), dup.hash())
        yield "verify_evidence: lunatic", verify(evidence["lunatic"]), [], ok
        yield "verify_evidence: equivocation", verify(evidence["equivocation"]), [last], ok
        yield "verify_evidence: duplicate vote", verify(dup), [], ok
        bad = copy.deepcopy(evidence["lunatic"])
        bad.total_voting_power += 7

        def tampered():
            try:
                V.verify_evidence(bad, state, node, node, **kw)
            except V.EvidenceABCIError as e:
                held["regenerate"] = e.regenerate
                raise

        yield "verify_evidence: lunatic, total power tampered", tampered, [], (
            "EvidenceABCIError", "total voting power from the evidence and our validator set does not match")

        def regenerated():
            held["regenerate"]()
            V.verify_evidence(bad, state, node, node, **kw)

        yield "verify_evidence: lunatic, regenerated", regenerated, [], ok
        expect("regenerated evidence", bad.to_proto().encode(), evidence["lunatic"].to_proto().encode())
        rewritten = copy.deepcopy(evidence["lunatic"])
        rewritten.conflicting_block.signed_header.header.proposer_address = b"\x01" * 20
        yield "verify_evidence: conflicting header rewritten after signing", verify(rewritten), [], (
            "EvidenceVerifyError", "invalid evidence: invalid conflicting light block")
        unknown = copy.deepcopy(evidence["lunatic"])
        unknown.common_height = top + 100
        yield f"verify_evidence: common height {top + 100}", verify(unknown), [], (
            "EvidenceVerifyError", "common height has to be less than equal")
        forged_vote = copy.deepcopy(dup)
        forged_vote.vote_b.signature = bytes(64)
        yield "verify_evidence: duplicate vote, vote B's signature forged", verify(forged_vote), [], (
            "EvidenceVerifyError", "verifying VoteB: invalid signature")
        bad_sig = (len(last.validators) * 5) // 12
        forged_commit = copy.deepcopy(evidence["equivocation"])
        cs_ = forged_commit.conflicting_block.signed_header.commit.signatures[bad_sig]
        cs_.signature = tamper(cs_.signature)
        yield f"verify_evidence: equivocation, signature #{bad_sig} forged", verify(forged_commit), [last], (
            "EvidenceVerifyError", f"verifying conflicting commit: wrong signature (#{bad_sig})")
        return {"facts": facts, "trace": [list(t) for t in trace], "times": times}


def run_script(script, step):
    """Drive a client_script: step(label, call, checked, want) returns the
    call's outcome, which must be `want` (its class, a fragment of its
    message); returns the script's result."""
    try:
        item = next(script)
        while True:
            label, call, checked, want = item
            got = step(label, call, checked, want)
            if got[0] != want[0] or want[1] not in got[1]:
                raise AssertionError(f"phase 11: {label}: {got}, expected {want}")
            item = script.send(got)
    except StopIteration as done:
        return done.value


def client_setup(pool, rng, chain_id):
    """Phase 11's chain on each plane, signed at set-up."""
    m = light_modules()

    def sign(secrets, msgs):
        return [sigs[0] for _, sigs in pool.map(
            _sign_worker, [(kind, seed, [msg]) for (kind, seed), msg in zip(secrets, msgs)],
            chunksize=16)]

    n, swaps = LIGHT_VALIDATORS, len(ROTATION_SWAPS)
    chains = {}
    for kind in PLANES:
        seeds = [rng.bytes(32) for _ in range(n + swaps * (n // 3))]
        fresh = [(kind, pub, (kind, seed)) for pub, seed in zip(make_keys(pool, kind, seeds), seeds)]
        chains[kind] = rotation_chain(m, fresh[:n], fresh[n:], sign, chain_id)
    return chains


def client_phase(planes, chain_id, chains, runs):
    """Phase 11 on each plane: every call of client_script with its launch
    counters zeroed just before it and read just after, held to the
    launches worked out from the keys its commit checks tally (a fill when
    one is new to the phase, then a hit; a check below the cutover, none);
    logs each call's wall time with the garbage collections inside it, each
    bisection step with its launches, the sequential syncs' adjacent steps
    and the detections' cost."""
    import gc

    m = light_modules()
    totals = {}
    paused = {"s": 0.0, "t0": None}

    def on_gc(stage, info):
        if stage == "start":
            paused["t0"] = time.perf_counter()
        elif paused["t0"] is not None:
            paused["s"] += time.perf_counter() - paused["t0"]
            paused["t0"] = None

    gc.callbacks.append(on_gc)
    try:
        for kind, P in planes.items():
            _client_plane(m, kind, P, chain_id, chains[kind], runs, totals, paused)
    finally:
        gc.callbacks.remove(on_gc)
    check_path("phase 11", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()])
    return totals


def _client_plane(m, kind, P, chain_id, chain, runs, totals, paused):
    """Phase 11 on one plane; `paused` sums the interpreter's garbage
    collections, which each call's line reports beside its time."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    seen, plane_totals = set(), {}

    def step(label, call, checked, want):
        expect = {}
        for vals in checked:
            keys = light_counted(vals)
            if len(keys) >= ed.DEVICE_BATCH_CUTOVER:
                expect[P.hit.__name__] = expect.get(P.hit.__name__, 0) + 1
                if not seen.issuperset(keys):
                    expect[P.fill.__name__] = expect.get(P.fill.__name__, 0) + 1
                seen.update(keys)
        gc0 = paused["s"]
        got, t = drive(f"phase 11: {kind} {label}", lambda: outcome(call), expect, plane_totals)
        runs.append({"plane": kind, "commit": LIGHT_VALIDATORS, "run": f"client {label}", "s": t})
        log(f"phase 11: {kind} {label}: {got[0]}{' (' + got[1][:70] + ')' if got[1] else ''}, "
            f"launches {json.dumps(expect)}, {t * 1e3:.2f} ms (garbage collection "
            f"{(paused['s'] - gc0) * 1e3:.2f}) on {card()}")
        return got

    done = run_script(client_script(m, chain, chain_id, counts=read_counts), step)
    adjacent = []
    for name, trusted, target, got, t, launched in done["trace"]:
        if got == "ErrNewValSetCantBeTrusted" and launched:
            raise AssertionError(f"phase 11: {kind} {name} {trusted} -> {target} failed after launching "
                                 f"{launched}")
        if name == "verify_adjacent":
            adjacent.append(t)
            continue
        log(f"phase 11: {kind} bisection step {trusted} -> {target}: {got}, launches "
            f"{json.dumps(launched)}, {t * 1e3:.2f} ms on {card()}")
    log(f"phase 11: {kind} {len(adjacent)} adjacent steps (sequential syncs): mean "
        f"{sum(adjacent) / len(adjacent) * 1e3:.2f} ms, min {min(adjacent) * 1e3:.2f}, max "
        f"{max(adjacent) * 1e3:.2f}, one hit each, on {card()}")
    for what, t in done["times"].items():
        log(f"phase 11: {kind} {what}: {t * 1e3:.3f} ms on {card()}")
    for name, c in plane_totals.items():
        totals[name] = totals.get(name, 0) + c


# -- phase 12: the state layer --------------------------------------------------------

STATE_VALIDATORS = 1000  # BASELINE.json config 3: blocksync replay of a 1,000-validator chain
STATE_HEIGHTS = 16
STATE_TXS = 3  # kv transactions a block
STATE_JOIN_AT = 5  # its val: transaction adds a validator, which signs from height 7
STATE_DOUBLE_SIGN_AT = 8  # a validator precommits two block IDs; block 9 carries the evidence
STATE_REJECT_AT = 12  # the height whose altered copies (b) refuses
STATE_T0 = LIGHT_T0
STATE_DT = LIGHT_DT
# (b): the header fields of tests/test_state_execution.py:234-246, each with
# the error class and the start of the message the reference raises for it
HEADER_MUTATIONS = {
    "version_app": ("InvalidBlockError", "wrong Block.Header.Version"),
    "chain_id": ("InvalidBlockError", "wrong Block.Header.ChainID"),
    "height": ("InvalidBlockError", "wrong Block.Header.Height"),
    "last_block_id": ("InvalidBlockError", "wrong Block.Header.LastBlockID"),
    "app_hash": ("InvalidBlockError", "wrong Block.Header.AppHash"),
    "consensus_hash": ("InvalidBlockError", "wrong Block.Header.ConsensusHash"),
    "last_results_hash": ("InvalidBlockError", "wrong Block.Header.LastResultsHash"),
    "validators_hash": ("InvalidBlockError", "wrong Block.Header.ValidatorsHash"),
    "next_validators_hash": ("InvalidBlockError", "wrong Block.Header.NextValidatorsHash"),
    "proposer_address": ("InvalidBlockError", "block.Header.ProposerAddress"),
    "time": ("InvalidBlockError", "block time"),
}
# validate_block checks these two after the LastCommit, the rest before it
AFTER_COMMIT_CHECK = ("proposer_address", "time")
APPLY_PARTS = ("validate_block", "verify_commit", "validate_basic", "set_hash", "check_evidence", "last_commit_info",
               "finalize_block", "commit", "state_update", "state_save", "responses_save", "evidence_update")
# the parts that run inside another part (validate_block, and set_hash
# wherever a validator set is hashed)
NESTED_PARTS = ("verify_commit", "validate_basic", "set_hash")


def state_modules():
    """The port's modules a state chain is built and replayed with (those of
    light_modules and the state layer's); the chain functions below take
    such a namespace, so the CPU tests can hand them the JAX package's
    instead."""
    from tendermint_tpu_torch import abci, state
    from tendermint_tpu_torch.abci import kvstore
    from tendermint_tpu_torch.abci import types as abci_types
    from tendermint_tpu_torch.evidence import pool
    from tendermint_tpu_torch.state import execution, store, validation
    from tendermint_tpu_torch.state import state as state_
    from tendermint_tpu_torch.store import blockstore
    from tendermint_tpu_torch.types import genesis, params, part_set
    from tendermint_tpu_torch.utils import bits

    return SimpleNamespace(**vars(light_modules()), abci=abci, abci_types=abci_types, kvstore=kvstore, state=state,
                           state_=state_, state_store=store, state_validation=validation, execution=execution,
                           pool=pool, blockstore=blockstore, genesis=genesis, params=params, part_set=part_set,
                           bits=bits)


class TxQueue:
    """A node's mempool as BlockExecutor drives it: the transactions queued
    for the next proposal, dropped once a block commits them."""

    max_gas = -1

    def __init__(self):
        self.txs = []

    def lock(self):
        pass

    def unlock(self):
        pass

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs)

    def update(self, height, txs, tx_results, recheck=True):
        self.txs = [tx for tx in self.txs if tx not in txs]


def state_genesis(m, members, chain_id):
    """The GenesisDoc of members [(kind, pub, secret)] at power 10 each, the
    consensus params admitting their key types, read back from the genesis
    file's JSON."""
    keys = [m.keys[kind](pub) for kind, pub, _ in members]
    kinds = tuple(sorted({kind for kind, _, _ in members}))
    doc = m.genesis.GenesisDoc(
        chain_id=chain_id, genesis_time=m.tmtime.Time(STATE_T0, 0),
        consensus_params=m.params.ConsensusParams(validator=m.params.ValidatorParams(pub_key_types=kinds)),
        validators=[m.genesis.GenesisValidator(address=k.address(), pub_key=k, power=10, name=f"v{i}")
                    for i, k in enumerate(keys)])
    doc.validate_and_complete()
    return m.genesis.GenesisDoc.from_json(doc.to_json())


def file_dbs(m, where):
    """A node's four FileDBs in the directory `where`."""
    os.makedirs(where, exist_ok=True)
    return {name: m.kv.FileDB(os.path.join(where, f"{name}.db")) for name in ("app", "state", "blocks", "evidence")}


def state_node(m, gen, dbs, device=None):
    """A node over the key-value stores dbs {"app", "state", "blocks",
    "evidence"}: KVStoreApplication behind LocalClient, StateStore,
    BlockStore, EvidencePool and BlockExecutor (`device` passed on unless
    None: the JAX package's take none). A fresh node runs InitChain and saves
    the genesis state; a reopened one carries on from its stores."""
    kw = {} if device is None else {"device": device}
    A = m.abci_types
    client = m.abci.LocalClient(m.kvstore.KVStoreApplication(dbs["app"]))
    states = m.state.StateStore(dbs["state"])
    blocks = m.blockstore.BlockStore(dbs["blocks"])
    state = states.load()
    if state is None:
        state = m.state.make_genesis_state(gen)
        client.init_chain(A.RequestInitChain(
            time_ns=gen.genesis_time.unix_ns(), chain_id=gen.chain_id, initial_height=gen.initial_height,
            consensus_params=gen.consensus_params.to_proto_update(),
            validators=[A.ValidatorUpdate(pub_key_type=v.pub_key.type_name, pub_key_bytes=v.pub_key.bytes(),
                                          power=v.power) for v in gen.validators]))
        states.save(state)
    pool = m.pool.EvidencePool(dbs["evidence"], states, blocks, **kw)
    mempool = TxQueue()
    executor = m.execution.BlockExecutor(states, client, mempool=mempool, evidence_pool=pool, block_store=blocks,
                                         **kw)
    return SimpleNamespace(client=client, app=client._app, states=states, blocks=blocks, pool=pool,
                           mempool=mempool, executor=executor, state=state, dbs=dbs)


def conflicting_votes(m, vals, secrets, sign, chain_id, height, time_):
    """Two precommits of vals' first validator at `height`, for two block IDs."""
    val = vals.validators[0]
    votes = []
    for tag in (b"double sign a", b"double sign b"):
        v = m.vote.Vote(type=m.vote.PRECOMMIT, height=height, round=0,
                        block_id=m.block.BlockID(tagged(tag, height),
                                                 m.block.PartSetHeader(1, tagged(tag + b" parts", height))),
                        timestamp=time_, validator_address=val.address, validator_index=0)
        v.signature = sign([secrets[val.address]], [v.sign_bytes(chain_id)])[0]
        votes.append(v)
    return votes


def state_chain(m, members, joiner, sign, chain_id, dbs, heights=STATE_HEIGHTS, device=None):
    """The source node's chain: `heights` blocks from create_proposal_block
    (STATE_TXS kv transactions each, an explicit block time), each commit
    signed by the height's whole set through sign(secrets, msgs) -> sigs,
    saved with its part set and seen commit, then applied. Block
    STATE_JOIN_AT carries a val: transaction adding `joiner` (a member) at
    power 10 (with its key type's prefix off ed25519); after saving block
    STATE_DOUBLE_SIGN_AT the source reports a validator's two conflicting
    precommits at it, which the pool turns into evidence when the block is
    applied and the next proposal carries. Returns the genesis doc, the node,
    the members' secrets, create_proposal_block's seconds at each height and
    {height: (the state before, block, block ID, app hash, state_to_json
    after, tx results hash)}."""
    import base64

    gen = state_genesis(m, members, chain_id)
    node = state_node(m, gen, dbs, device)
    secrets = member_secrets(m, list(members) + [joiner])
    kind, pub, _ = joiner
    join_tx = b"val:" + (b"" if kind == "ed25519" else kind.encode() + b":") + base64.b64encode(pub) + b"!10"
    state, last_commit = node.state, m.block.Commit()
    chain, proposal_s = {}, []
    for h in range(1, heights + 1):
        node.mempool.txs = [b"key-%d-%d=value-%d" % (h, i, i) for i in range(STATE_TXS)]
        if h == STATE_JOIN_AT:
            node.mempool.txs.append(join_tx)
        t0 = time.perf_counter()
        block = node.executor.create_proposal_block(h, state, last_commit, state.validators.get_proposer().address,
                                                    block_time=m.tmtime.Time(STATE_T0 + STATE_DT * h, 1000 * h))
        proposal_s.append(time.perf_counter() - t0)
        parts = block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES)
        block_id = m.block.BlockID(block.hash(), parts.header)
        seen = signed_commit(m, state.validators, secrets, sign, chain_id, h, block_id, STATE_T0 + STATE_DT * h)
        node.blocks.save_block(block, parts, seen)
        if h == STATE_DOUBLE_SIGN_AT:
            node.pool.report_conflicting_votes(*conflicting_votes(m, state.validators, secrets, sign, chain_id, h,
                                                                  block.header.time))
        before = state
        state = node.executor.apply_block(state, block_id, block)
        results = node.states.load_finalize_block_responses(h)
        chain[h] = (before, block, block_id, state.app_hash, m.state_store.state_to_json(state),
                    m.execution.tx_results_hash(results.tx_results))
        last_commit = seen
    node.state = state
    return SimpleNamespace(gen=gen, node=node, secrets=secrets, proposal_s=proposal_s, chain=chain)


def header_mutations(m, state, height):
    """(b)'s altered headers of a block at `height` on `state`, by field, as
    tests/test_state_execution.py:234-246 makes them."""
    x = b"\x55"
    return {"version_app": 99, "chain_id": "other-chain", "height": height + 1,
            "last_block_id": m.block.BlockID(hash=x * 32), "app_hash": x * 8, "consensus_hash": x * 32,
            "last_results_hash": x * 32, "validators_hash": x * 32, "next_validators_hash": x * 32,
            "proposer_address": x * 20, "time": m.tmtime.Time.from_unix_ns(state.last_block_time.unix_ns() - 1)}


def mutated_block(block, field, value):
    import copy

    b = copy.deepcopy(block)
    setattr(b.header, field, value)
    return b


def tampered_block(m, block, idx):
    """A copy of block whose LastCommit has signature #idx tampered, its
    header's last_commit_hash made to match, so that validate_basic passes
    and the commit check finds the signature."""
    import copy

    b = copy.deepcopy(block)
    b.last_commit = tampered_commit(m, block.last_commit, idx)
    b.header.last_commit_hash = b.last_commit.hash()
    return b


def trusting_counted(trusted, signers, frac=(1, 3)):
    """The keys a trusting check of `trusted` tallies over a commit that
    every validator of `signers` signed, in the set's order."""
    needed = trusted.total_voting_power() * frac[0] // frac[1]
    power = {v.address: v.voting_power for v in trusted.validators}
    tallied = n = 0
    for v in signers.validators:
        if v.address in power:
            n += 1
            tallied += power[v.address]
            if tallied > needed:
                break
    return n


def rlc_launches(P, counted):
    """The launches of commit checks of valid commits that tally `counted`
    keys each: the RLC from MSM_BATCH_CUTOVER up, the host below
    DEVICE_BATCH_CUTOVER (phase 12 makes no check in between)."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    n = 0
    for keys in counted:
        if ed.DEVICE_BATCH_CUTOVER <= keys < ed.MSM_BATCH_CUTOVER:
            raise AssertionError(f"phase 12: a {keys}-key check would take the cached bitmap")
        n += keys >= ed.MSM_BATCH_CUTOVER
    return {P.rlc.__name__: n} if n else {}


def apply_split(m, node):
    """Times the parts of node's apply_block (call_times, yielding {part:
    [(end, seconds)]}): validate_block (of which verify_commit,
    Block.validate_basic and the validator-set hashes), check_evidence,
    build_last_commit_info (the last set loaded from the state store), ABCI
    FinalizeBlock and Commit, State.update, the state store's writes (the
    state, and the FinalizeBlock responses) and the evidence pool's
    update."""
    return call_times([(m.execution, "validate_block", "validate_block", None),
                       (m.state_validation, "verify_commit", "verify_commit", None),
                       (m.block.Block, "validate_basic", "validate_basic", None),
                       (m.vs.ValidatorSet, "hash", "set_hash", None),
                       (node.pool, "check_evidence", "check_evidence", None),
                       (node.executor, "build_last_commit_info", "last_commit_info", None),
                       (node.client, "finalize_block", "finalize_block", None), (node.client, "commit", "commit", None),
                       (m.state_.State, "update", "state_update", None), (node.states, "save", "state_save", None),
                       (node.states, "save_finalize_block_responses", "responses_save", None),
                       (node.pool, "update", "evidence_update", None)])


def state_setup(pool, rng, chain_id, tmp):
    """Phase 12's source chains, signed and applied at set-up: on each plane
    a source node over FileDBs under tmp builds state_chain over
    STATE_VALIDATORS fresh keys and one joiner; then the lunatic witness's
    block at the last height (the set of height 1 re-signs its header with a
    forged app hash and itself as the validators)."""
    m = state_modules()
    sign = pool_signer(pool)
    built = {}
    for kind in PLANES:
        seeds = [rng.bytes(32) for _ in range(STATE_VALIDATORS + 1)]
        fresh = [(kind, pub, (kind, seed)) for pub, seed in zip(make_keys(pool, kind, seeds), seeds)]
        src = state_chain(m, fresh[:-1], fresh[-1], sign, chain_id, file_dbs(m, os.path.join(tmp, kind, "source")))
        header = src.chain[STATE_HEIGHTS][1].header
        common = src.chain[1][0].validators
        lunatic = resign(m, common, src.secrets, sign, chain_id, header, app_hash=FORGED_APP_HASH,
                         validators_hash=common.hash(), next_validators_hash=common.hash(),
                         proposer_address=common.get_proposer().address)
        built[kind] = SimpleNamespace(src=src, lunatic=lunatic, joiner=fresh[-1])
    return built


def state_phase(planes, chain_id, built, runs, tmp):
    """Phase 12 on each plane: the replay, the rejections and the light
    client over the replica's stores, every call with its launch counters
    zeroed just before it and read just after; logs the split of
    apply_block, the replay's blocks per second, load_block and the
    source's create_proposal_block, with the garbage collections."""
    import gc

    m = state_modules()
    totals = {}
    paused = {"s": 0.0, "t0": None}

    def on_gc(stage, info):
        if stage == "start":
            paused["t0"] = time.perf_counter()
        elif paused["t0"] is not None:
            paused["s"] += time.perf_counter() - paused["t0"]
            paused["t0"] = None

    gc.callbacks.append(on_gc)
    try:
        for kind, P in planes.items():
            _state_plane(m, kind, P, chain_id, built[kind], runs, totals, paused, os.path.join(tmp, kind, "replica"))
    finally:
        gc.callbacks.remove(on_gc)
    check_path("phase 12", totals, [{P.rlc.__name__: 1, P.fill.__name__: 1, P.hit.__name__: 1}
                                    for P in planes.values()])
    return totals


def _state_plane(m, kind, P, chain_id, built, runs, totals, paused, where):
    """Phase 12 on one plane: (a) a fresh node replays the source's blocks,
    (b) refuses altered copies, (c) serves a light client and judges its
    attack evidence; then its reopened stores must give the same state."""
    src, top = built.src, STATE_HEIGHTS
    plane_totals = {}
    rlc = {P.rlc.__name__: 1}
    on = f"on {card()}"

    def expect(what, got, want):
        if got != want:
            raise AssertionError(f"phase 12: {kind} {what}: {got}, expected {want}")

    def refuse(label, node, state, block, want_launches, want):
        got, t = drive(f"phase 12: {kind} {label}", lambda: outcome(
            lambda: node.executor.apply_block(state, m.block.BlockID(), block)), want_launches, plane_totals)
        if got[0] != want[0] or want[1] not in got[1]:
            raise AssertionError(f"phase 12: {kind} {label}: {got}, expected {want}")
        log(f"phase 12: {kind} {label}: {got[0]} ({got[1][:70]}), launches {json.dumps(want_launches)}, "
            f"{t * 1e3:.2f} ms {on}")

    def rejections(node, state, block):
        h = block.header.height
        for field, value in header_mutations(m, state, h).items():
            want = rlc if h > 1 and field in AFTER_COMMIT_CHECK else {}
            refuse(f"height {h}, {field} altered", node, state, mutated_block(block, field, value), want,
                   HEADER_MUTATIONS[field])
        if h == 1:
            return
        idx = (state.last_validators.size() * 5) // 12
        refuse(f"height {h}, LastCommit signature #{idx} tampered", node, state, tampered_block(m, block, idx),
               {P.rlc.__name__: 1, P.fill.__name__: 1, P.hit.__name__: 1},
               ("ValueError", f"wrong signature (#{idx})"))

    # (a) the replay, as blocksync applies: load, save, apply
    node = state_node(m, src.gen, file_dbs(m, where))
    state, rows = node.state, []
    with apply_split(m, node) as spent:
        for h in range(1, top + 1):
            t0 = time.perf_counter()
            block = src.node.blocks.load_block(h)
            t_load = time.perf_counter() - t0
            block_id = src.node.blocks.load_block_meta(h).block_id
            seen = src.node.blocks.load_seen_commit(h)
            if h in (1, STATE_REJECT_AT):
                rejections(node, state, block)
            t0 = time.perf_counter()
            parts = block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES)
            t_parts = time.perf_counter() - t0
            expect(f"height {h} part set", parts.header, block_id.part_set_header)
            t0 = time.perf_counter()
            node.blocks.save_block(block, parts, seen)
            t_save = time.perf_counter() - t0
            spent.clear()
            gc0 = paused["s"]
            want = {} if h == 1 else rlc
            state, t = drive(f"phase 12: {kind} apply_block {h}",
                             lambda: node.executor.apply_block(state, block_id, block), want, plane_totals)
            log(f"phase 12: {kind} apply_block {h} ({len(block.txs)} txs, {len(block.evidence)} evidence): "
                f"launches {json.dumps(want)}, {t * 1e3:.2f} ms {on}")
            parts = {k: sum(x for _, x in v) for k, v in spent.items()}
            rows.append({"height": h, "apply": t, "load_block": t_load, "part_set": t_parts, "block_store": t_save,
                         "gc": paused["s"] - gc0, **parts,
                         "rest": t - sum(v for k, v in parts.items() if k not in NESTED_PARTS)})
            before, _, _, app_hash, doc, results_hash = src.chain[h]
            expect(f"height {h} app hash", state.app_hash, app_hash)
            expect(f"height {h} state_to_json", m.state_store.state_to_json(state), doc)
            expect(f"height {h} tx results hash", m.execution.tx_results_hash(
                node.states.load_finalize_block_responses(h).tx_results), results_hash)
            if h in (STATE_JOIN_AT, STATE_DOUBLE_SIGN_AT + 1):
                # the app's validator update at h: the set of h + 2
                expect(f"height {h} next validators", state.next_validators.hash(),
                       src.chain[h + 2][0].validators.hash())
                if state.next_validators.hash() == state.validators.hash():
                    raise AssertionError(f"phase 12: {kind} the validator update at {h} changed nothing")
    expect("end state", m.state_store.state_to_json(state), m.state_store.state_to_json(src.node.state))
    evidenced = src.chain[STATE_DOUBLE_SIGN_AT + 1][1].evidence
    expect("evidence in the block after the double sign", [type(e).__name__ for e in evidenced],
           ["DuplicateVoteEvidence"])
    signer = src.chain[STATE_DOUBLE_SIGN_AT][0].validators.validators[0]
    punished = node.states.load_finalize_block_responses(STATE_DOUBLE_SIGN_AT + 1).validator_updates
    expect("the double signer's power", [(u.pub_key_bytes, u.power) for u in punished],
           [(signer.pub_key.bytes(), signer.voting_power - 1)])
    # (b) the committed evidence proposed again, at the next height
    again = state.make_block(top + 1, [], src.node.blocks.load_seen_commit(top), list(evidenced),
                             state.validators.get_proposer().address,
                             m.tmtime.Time(STATE_T0 + STATE_DT * (top + 1), 0))
    refuse(f"height {top + 1}, committed evidence again", node, state, again, rlc,
           ("EvidenceError", "evidence was already committed"))

    # (c) a light client over the replica's stores, and its attack evidence
    now = m.tmtime.Time(STATE_T0 + STATE_DT * top + 60)
    sets = {h: node.states.load_validators(h) for h in range(1, top + 1)}
    trust = m.light.TrustOptions(period_ns=TRUSTING_PERIOD_NS, height=1,
                                 hash=node.blocks.load_block_meta(1).header.hash())
    steps, mids = bisection_model({h: SimpleNamespace(validator_set=v) for h, v in sets.items()}, 1, top)
    checks = []
    for cur, to, passes in steps:
        checks.append(trusting_counted(sets[cur], sets[to]))
        if passes:
            checks.append(len(light_counted(sets[to])))
    served = {h: m.light.LocalProvider(chain_id, node.blocks, node.states).light_block(h) for h in sets}
    for name, witnesses in (("no witness", []), ("lunatic witness", [chain_provider(
            m, chain_id, {**served, top: built.lunatic}, "lunatic witness")])):
        primary = recording_provider(m, chain_id, node.blocks, node.states, "primary")
        held = {}

        def make():
            held["c"] = m.light.LightClient(chain_id, trust, primary, witnesses=witnesses,
                                            trusted_store=m.light.MemLightStore(), clock=lambda: now)
        got, t = drive(f"phase 12: {kind} light client ({name}): trust height 1", lambda: outcome(make),
                       rlc_launches(P, [len(light_counted(sets[1]))]), plane_totals)
        expect(f"light client ({name}) trust", got, ("accepted", ""))
        # the detection compares the witness's header by hash and builds the
        # evidence from the light store: no commit check of its own
        want = rlc_launches(P, checks)
        got, t = drive(f"phase 12: {kind} light client ({name}): verify to {top}",
                       lambda: outcome(lambda: held["c"].verify_light_block_at_height(top)), want, plane_totals)
        log(f"phase 12: {kind} light client ({name}): verify 1 -> {top}: {got[0]}, launches {json.dumps(want)}, "
            f"fetched {primary.fetched}, {t * 1e3:.2f} ms {on}")
        if not witnesses:
            expect("light client verify", got, ("accepted", ""))
            expect("light client fetched", primary.fetched, [1, top] + mids)
            continue
        expect("light client against the lunatic witness", got[0], "ErrLightClientAttack")
        ev = held["c"].latest_attack_evidence
        expect("the attack evidence's common height", ev.common_height, 1)
        got, t = drive(f"phase 12: {kind} EvidencePool.add_evidence (lunatic)",
                       lambda: outcome(lambda: node.pool.add_evidence(ev)),
                       rlc_launches(P, [trusting_counted(sets[1], sets[1])]), plane_totals)
        expect("add_evidence", got, ("accepted", ""))
        expect("pending evidence", [e.hash() for e in node.pool.pending_evidence(1 << 20)[0]], [ev.hash()])
        log(f"phase 12: {kind} EvidencePool.add_evidence of the lunatic attack: accepted, launches "
            f"{json.dumps(rlc_launches(P, [trusting_counted(sets[1], sets[1])]))}, {t * 1e3:.2f} ms {on}")

    # the replica's stores reopened
    pending = [e.hash() for e in node.pool.pending_evidence(1 << 20)[0]]
    for db in node.dbs.values():
        db.close()
    again = state_node(m, src.gen, file_dbs(m, where))
    expect("reopened state", m.state_store.state_to_json(again.states.load()), m.state_store.state_to_json(state))
    expect("reopened block store", (again.blocks.base(), again.blocks.height()), (1, top))
    expect("reopened pool", [e.hash() for e in again.pool.pending_evidence(1 << 20)[0]], pending)
    info = again.client.info(m.abci_types.RequestInfo())
    expect("reopened app", (info.last_block_height, info.last_block_app_hash), (top, state.app_hash))
    for db in again.dbs.values():
        db.close()

    # times, over heights 2..16
    later = rows[1:]

    def spread(key, scale=1e3):
        xs = [r.get(key, 0.0) * scale for r in later]
        return f"mean {sum(xs) / len(xs):.2f}, range {min(xs):.2f}-{max(xs):.2f}"

    log(f"phase 12: {kind} apply_block of a {STATE_VALIDATORS}-validator block, heights 2-{top}, ms: "
        + "; ".join(f"{k} {spread(k)}" for k in ("apply",) + APPLY_PARTS + ("rest", "gc")) + f" {on}")
    replay_s = sum(r["apply"] + r["load_block"] + r["part_set"] + r["block_store"] for r in later)
    log(f"phase 12: {kind} replay: {len(later) / replay_s:.2f} blocks/s (load_block, make_part_set, save_block, "
        f"apply_block), load_block {spread('load_block')} ms, make_part_set {spread('part_set')} ms, save_block "
        f"{spread('block_store')} ms, the source's "
        f"create_proposal_block mean {sum(src.proposal_s[1:]) / (top - 1) * 1e3:.2f} ms {on}")
    for r in later:
        runs.append({"plane": kind, "commit": STATE_VALIDATORS, "run": f"apply_block {r['height']}", "s": r["apply"],
                     **{f"{k}_s": r.get(k, 0.0) for k in APPLY_PARTS + ("rest", "gc")}})
    for name, c in plane_totals.items():
        totals[name] = totals.get(name, 0) + c


# -- phase 13: blocksync on the port's p2p layer --------------------------------------

BLOCKSYNC_TAMPER_AT = 12  # (b): a second peer serves this block, its LastCommit (proving 11) altered
BLOCKSYNC_TAMPER_INDEX = 2  # among the first 667 signatures the light check counts
BLOCKSYNC_EXT_AT = 12  # (c): the height whose seen commit is extended
BLOCKSYNC_PEERS = ("a1" * 20, "b2" * 20, "c3" * 20)  # (a)-(c)'s serving peers, by node ID
BLOCKSYNC_TIMEOUT_S = 300
SYNC_PARTS = ("light_sync", "ahead_dispatch", "ahead_wait", "make_part_set", "save_block", "apply_block",
              "load_block")


def blocksync_modules():
    """The port's modules a chain is synced with: state_modules' and the p2p
    layer's, blocksync's (its pool as bs_pool), the batch verifier's seam,
    the wire messages, the metrics and the node key type."""
    from tendermint_tpu_torch import blocksync, metrics, p2p
    from tendermint_tpu_torch.blocksync import pool as bs_pool
    from tendermint_tpu_torch.blocksync import reactor
    from tendermint_tpu_torch.crypto import batch, ed25519
    from tendermint_tpu_torch.proto import messages as pb

    return SimpleNamespace(**vars(state_modules()), blocksync=blocksync, bs_pool=bs_pool, reactor=reactor, p2p=p2p,
                           pb=pb, metrics=metrics, batch=batch, node_key=ed25519.Ed25519PrivKey)


class StubChannel:
    """A reactor's channel that records what it sends and the peer errors it
    reports, and delivers the envelopes of `inbox`, in order."""

    def __init__(self, inbox=()):
        self.sent, self.errors, self.inbox = [], [], list(inbox)

    def send_to(self, peer_id, message, timeout=None):
        self.sent.append((peer_id, message))
        return True

    def broadcast(self, message, timeout=None):
        self.sent.append(("", message))
        return True

    def send_error(self, err):
        self.errors.append(err)

    def receive_one(self, timeout=None):
        if self.inbox:
            return self.inbox.pop(0)
        time.sleep(timeout or 0)


class StubPeers:
    """A peer manager with no peers."""

    def subscribe(self, callback):
        pass

    def unsubscribe(self, callback):
        pass

    def peers(self):
        return []


def sync_node(m, gen, dbs, device=None):
    """A fresh node over dbs (state_node) with a BlockSyncReactor on a
    StubChannel (`device` passed on unless None); returns (node, reactor,
    channel)."""
    node = state_node(m, gen, dbs, device)
    ch = StubChannel()
    kw = {} if device is None else {"device": device}
    return node, m.reactor.BlockSyncReactor(node.state, node.executor, node.blocks, ch, StubPeers(), **kw), ch


def serve(reactor, block_at, peer, lo, hi, ext_at=None):
    """Heights lo..hi assigned to peer in reactor's pool and delivered:
    block_at(h), with ext_at(h) as its extended commit where given."""
    reactor.pool.set_peer_range(peer, lo, hi)
    reactor.pool._fill_requests()
    for h in range(lo, hi + 1):
        if not reactor.pool.add_block(peer, block_at(h), ext_commit=ext_at(h) if ext_at else None):
            raise AssertionError(f"the pool refused block {h} from its requester")


def extended_commit(m, commit, secrets, sign, chain_id):
    """An ExtendedCommit (m.pb's) of commit's signatures, each COMMIT slot
    with a vote extension its validator signs over the canonical
    vote-extension bytes through sign(secrets, msgs) -> sigs."""
    pb = m.pb
    ec = pb.ExtendedCommit(height=commit.height, round=commit.round, block_id=commit.block_id.to_proto(),
                           extended_signatures=[pb.ExtendedCommitSig(
                               block_id_flag=s.block_id_flag, validator_address=s.validator_address,
                               timestamp=pb.Timestamp(seconds=s.timestamp.seconds, nanos=s.timestamp.nanos),
                               signature=s.signature,
                               extension=b"ext-%d-%d" % (commit.height, i) if s.block_id_flag == 2 else b"")
                               for i, s in enumerate(commit.signatures)])
    votes = m.vote.votes_from_extended_commit(ec)
    idx = [i for i, v in enumerate(votes) if v is not None and not v.block_id.is_nil()]
    sigs = sign([secrets[votes[i].validator_address] for i in idx], [votes[i].extension_sign_bytes(chain_id)
                                                                      for i in idx])
    for i, sig in zip(idx, sigs):
        ec.extended_signatures[i].extension_signature = sig
    return ec


def altered_ext(ec, idx, field):
    """A copy of ec with extended signature idx's `field` (signature or
    extension_signature) altered."""
    import copy

    out = copy.deepcopy(ec)
    sig = out.extended_signatures[idx]
    setattr(sig, field, tamper(getattr(sig, field)))
    return out


def bs_node(m, net, seed, node, chain_id, block_sync, on_caught_up=None, on_fatal=None, device=None):
    """A node exposing only a BlockSyncReactor over node's state, executor
    and block store on the p2p Router over the MemoryNetwork net, as
    tests/test_blocksync.py's BSNode builds one: the node key from seed, a
    PeerManager, the blocksync channel."""
    key = m.node_key.generate(bytes([seed]) * 32)
    nid = m.p2p.node_id_from_pubkey(key.pub_key())
    pm = m.p2p.PeerManager(nid, m.p2p.PeerManagerOptions(max_connected=8))
    router = m.p2p.Router(m.p2p.NodeInfo(node_id=nid, network=chain_id), key, pm, [net.create_transport(nid)])
    ch = router.open_channel(m.reactor.blocksync_channel_descriptor())
    kw = {} if device is None else {"device": device}
    reactor = m.reactor.BlockSyncReactor(node.states.load(), node.executor, node.blocks, ch, pm,
                                         on_caught_up=on_caught_up, block_sync=block_sync, on_fatal=on_fatal, **kw)
    return SimpleNamespace(nid=nid, pm=pm, router=router, reactor=reactor,
                           endpoint=m.p2p.Endpoint(protocol="memory", host=nid, node_id=nid))


def threaded_sync(m, src_node, node, chain_id, device=None, timeout=BLOCKSYNC_TIMEOUT_S):
    """A server (block_sync=False over src_node's stores) and node's syncing
    reactor (block_sync=True) on two Routers over one MemoryNetwork, the
    syncing one dialing the server; returns (blocks synced, its state, wall
    seconds from the start to on_caught_up), raising what on_fatal gets."""
    import threading

    net = m.p2p.MemoryNetwork()
    done, got = threading.Event(), {}

    def caught_up(state, n):
        got.update(state=state, n=n, t=time.perf_counter())
        done.set()

    def fatal(exc):
        got["exc"] = exc
        done.set()

    server = bs_node(m, net, 0x51, src_node, chain_id, block_sync=False, device=device)
    client = bs_node(m, net, 0x52, node, chain_id, block_sync=True, on_caught_up=caught_up, on_fatal=fatal,
                     device=device)
    t0 = time.perf_counter()
    for n in (server, client):
        n.router.start()
        n.reactor.start()
    try:
        client.pm.add(server.endpoint)
        if not done.wait(timeout):
            raise AssertionError(f"blocksync stuck at {client.reactor.pool.height}")
    finally:
        for n in (client, server):
            n.reactor.stop()
            n.router.stop()
    if "exc" in got:
        raise got["exc"]
    return got["n"], got["state"], got["t"] - t0


@contextlib.contextmanager
def call_times(targets):
    """Each call of the targets [(object, attribute, part, wait part or
    None)] timed into the yielded {part: [(end time, seconds)]}, from any
    thread; where a wait part is named, the call returns a completion
    callable (the verify-ahead's), whose calls are timed under it."""
    spent = {}

    def record(part, t0):
        t1 = time.perf_counter()
        spent.setdefault(part, []).append((t1, t1 - t0))

    def timed_call(real, part, wait):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                out = real(*a, **k)
            finally:
                record(part, t0)
            return out if wait is None else timed_call(out, wait, None)
        return call

    saved = []
    for obj, name, part, wait in targets:
        real = getattr(obj, name) if not isinstance(obj, type) else obj.__dict__[name]
        saved.append((obj, name, real))
        setattr(obj, name, timed_call(real, part, wait))
    try:
        yield spent
    finally:
        for obj, name, real in saved:
            setattr(obj, name, real)


@contextlib.contextmanager
def rlc_rows():
    """The rows of every RLC dispatch that launched, by plane, counted into
    the yielded dict where the dispatch returns (ops/msm.py's two entry
    points, which the engine and direct dispatch call)."""
    from tendermint_tpu_torch.ops import msm as M

    rows, saved = {}, []
    for name, kind in (("verify_batch_rlc_async", "ed25519"), ("verify_batch_rlc_sr_async", "sr25519")):
        real = getattr(M, name)

        def counted(pubkeys, msgs, sigs, *a, _real=real, _kind=kind, **k):
            handle = _real(pubkeys, msgs, sigs, *a, **k)
            if handle is not None:
                rows[_kind] = rows.get(_kind, 0) + len(sigs)
            return handle

        saved.append((name, real))
        setattr(M, name, counted)
    try:
        yield rows
    finally:
        for name, real in saved:
            setattr(M, name, real)


def pool_signer(pool):
    """sign(secrets, msgs) -> sigs on the set-up's process pool."""
    def sign(secrets, msgs):
        return [sigs[0] for _, sigs in pool.map(
            _sign_worker, [(kind, seed, [msg]) for (kind, seed), msg in zip(secrets, msgs)], chunksize=16)]
    return sign


def blocksync_setup(pool, chain_id, built):
    """Phase 13's extended commits, signed at set-up: on each plane the seen
    commit of phase 12's source chain at BLOCKSYNC_EXT_AT, every COMMIT
    slot with its validator's extension signature."""
    m = blocksync_modules()
    sign = pool_signer(pool)
    for b in built.values():
        b.ext = extended_commit(m, b.src.node.blocks.load_seen_commit(BLOCKSYNC_EXT_AT), b.src.secrets, sign,
                                chain_id)


def blocksync_phase(planes, chain_id, built, runs, tmp):
    """Phase 13 on each plane, over phase 12's source chain: (a) the
    hand-driven sync, (b) the tampered block, (c) the extended commits, (d)
    the threaded sync over two routers; every call held to its launches and
    RLC rows."""
    m = blocksync_modules()
    totals = {}
    with rlc_rows() as rows:
        for kind, P in planes.items():
            _blocksync_plane(m, kind, P, chain_id, built[kind], runs, totals, rows, os.path.join(tmp, kind, "sync"))
    check_path("phase 13", totals, [{P.rlc.__name__: 1, P.hit.__name__: 1} for P in planes.values()])
    return totals


def _blocksync_plane(m, kind, P, chain_id, built, runs, totals, rows, where):
    import torch

    src, top = built.src, STATE_HEIGHTS
    plane_totals = {}
    on = f"on {card()}"
    rlc = P.rlc.__name__
    peer_a, peer_b, peer_c = BLOCKSYNC_PEERS
    sets = {h: src.chain[h][0].validators for h in src.chain}
    light = {h: len(light_counted(v)) for h, v in sets.items()}

    def expect(what, got, want):
        if got != want:
            raise AssertionError(f"phase 13: {kind} {what}: {got}, expected {want}")

    def iteration(h, first, last):
        """(launches, RLC rows) of the sync of height h: its light check
        where the iteration finds no verify-ahead (first), the verify-ahead
        of h + 1 unless block h + 2 is missing (last), validate_block's
        LastCommit check from height 2."""
        checks = [light[h]] * first + [light[h + 1]] * (not last) + ([sets[h - 1].size()] if h > 1 else [])
        return ({rlc: len(checks)} if checks else {}), sum(checks)

    def held_blocks(node, h, what):
        for load in ("load_block", "load_block_meta", "load_seen_commit"):
            got, want = getattr(node.blocks, load)(h), getattr(src.node.blocks, load)(h)
            expect(f"{what} {load}({h})", got.to_proto().encode(), want.to_proto().encode())
        expect(f"{what} tx results hash at {h}", m.execution.tx_results_hash(
            node.states.load_finalize_block_responses(h).tx_results), src.chain[h][5])

    def held(node, state, h, what):
        held_blocks(node, h, what)
        expect(f"{what} app hash at {h}", state.app_hash, src.chain[h][3])
        expect(f"{what} state_to_json at {h}", m.state_store.state_to_json(state), src.chain[h][4])

    def steps(reactor, node, lo, hi, what, first=None):
        """_try_sync_one for heights lo..hi, each held to its launches,
        rows, stores and state; heights lo and lo + 1 in one drive, since
        the verify-ahead of lo + 1 may still be in the engine's queue when
        the sync of lo returns (height 1 makes no check of its own)."""
        times = []
        h = lo
        while h <= hi:
            span = [h, h + 1] if h == lo and hi > lo else [h]
            want, want_rows = {}, 0
            for x in span:
                launches, n = iteration(x, x == lo if first is None else x == first, x + 2 > top)
                want = {rlc: want.get(rlc, 0) + launches.get(rlc, 0)} if launches or want else {}
                want_rows += n
            got, t = drive(f"phase 13: {kind} {what} heights {span}",
                           lambda: [(reactor._try_sync_one(), reactor.state) for _ in span], want, plane_totals,
                           rows=(rows, kind, want_rows), merge=rlc)
            for x, (ok, state) in zip(span, got):
                expect(f"{what} _try_sync_one at {x}", ok, True)
                held(node, state, x, what)
            times.append((span, t))
            h = span[-1] + 1
        return times

    def bitmap_launches(vals, counted):
        cache = P.cache()
        want = {P.hit.__name__: 1}
        if any(v.pub_key.bytes() not in cache._lru for v in vals.validators[:counted]):
            want[P.fill.__name__] = 1
        return want

    # (a) hand-driven: blocks 1-16 from the source's store, 15 iterations
    r0 = rows.get(kind, 0)
    node, reactor, ch = sync_node(m, src.gen, file_dbs(m, os.path.join(where, "a")))
    serve(reactor, src.node.blocks.load_block, peer_a, 1, top)
    consumed = []
    real_try = reactor._try_sync_one

    def tracked():
        consumed.append(reactor._verify_ahead is not None)
        return real_try()

    reactor._try_sync_one = tracked
    times = steps(reactor, node, 1, top - 1, "(a)")
    expect("(a) verify-ahead consumed", consumed, [False] + [True] * (top - 2))
    expect("(a) peer errors", ch.errors, [])
    launches_a, rows_a = plane_totals.get(rlc, 0), rows.get(kind, 0) - r0
    later = [t * 1e3 for span, t in times if len(span) == 1]
    log(f"phase 13: {kind} (a) _try_sync_one x {top - 1}: launches {json.dumps({rlc: launches_a})} carrying "
        f"{rows_a} RLC rows ({top - 1} light checks of {light[1]}-{max(light.values())} signatures, {top - 2} "
        f"validate_block checks of {sets[1].size()}-{max(v.size() for v in sets.values())}), the verify-ahead "
        f"consumed at heights 2-{top - 1}; ms a call, heights 3-{top - 1}: mean {sum(later) / len(later):.2f}, "
        f"range {min(later):.2f}-{max(later):.2f} {on}")

    # (b) block 12 from a second peer, its LastCommit signature #2 altered
    bad_h, idx = BLOCKSYNC_TAMPER_AT - 1, BLOCKSYNC_TAMPER_INDEX
    node_b, reactor_b, ch_b = sync_node(m, src.gen, file_dbs(m, os.path.join(where, "b")))
    serve(reactor_b, src.node.blocks.load_block, peer_a, 1, bad_h)
    tampered = tampered_block(m, src.node.blocks.load_block(BLOCKSYNC_TAMPER_AT), idx)
    serve(reactor_b, lambda h: tampered if h == BLOCKSYNC_TAMPER_AT else src.node.blocks.load_block(h),
          peer_b, BLOCKSYNC_TAMPER_AT, top)
    steps(reactor_b, node_b, 1, bad_h - 2, "(b)")
    # height 10 dispatches the verify-ahead of 11 on the altered commit: the
    # RLC fails and the engine's collect runs the cached bitmap before
    # validate_block's check of 10 returns; height 11 then refuses
    launches, n = iteration(bad_h - 1, False, False)
    want = dict(launches)
    for name, c in bitmap_launches(sets[bad_h], light[bad_h]).items():
        want[name] = want.get(name, 0) + c
    got, t = drive(f"phase 13: {kind} (b) heights [{bad_h - 1}, {bad_h}]",
                   lambda: [reactor_b._try_sync_one(), reactor_b._try_sync_one()], want, plane_totals,
                   rows=(rows, kind, n), merge=rlc)
    expect("(b) _try_sync_one", got, [True, False])
    err = f"wrong signature (#{idx}):"
    expect("(b) peer errors", [(e.node_id, str(e.err)[:len(err)]) for e in ch_b.errors],
           [(peer_b, err), (peer_a, err)])
    expect("(b) pool after the refusal", (sorted(reactor_b.pool.peers), reactor_b.pool.height,
                                          sorted(reactor_b.pool.requesters), sorted(reactor_b.pool.blocks)),
           ([], bad_h, [], []))
    log(f"phase 13: {kind} (b) block {BLOCKSYNC_TAMPER_AT} from a second peer with LastCommit signature #{idx} "
        f"altered: refused ({str(ch_b.errors[0].err)[:60]}), both senders reported, heights {bad_h} and "
        f"{BLOCKSYNC_TAMPER_AT} redone; heights {bad_h - 1}-{bad_h} launched {json.dumps(want)}, "
        f"{t * 1e3:.2f} ms {on}")
    serve(reactor_b, src.node.blocks.load_block, peer_c, bad_h, top)
    steps(reactor_b, node_b, bad_h, top - 1, "(b) honest", first=bad_h)
    expect("(b) peer errors at the end", len(ch_b.errors), 2)

    # (c) the extended commit at BLOCKSYNC_EXT_AT: direct dispatch, then the engine
    h = BLOCKSYNC_EXT_AT
    vals, block_id = sets[h], src.chain[h][2]
    check = functools.partial(reactor._validate_ext_commit, height=h, first_id=block_id, vals=vals,
                              chain_id=chain_id)
    n_ext = sum(1 for s in built.ext.extended_signatures if s.block_id_flag == 2)
    cases = (("honest", built.ext, None),
             ("extension signature #3 altered", altered_ext(built.ext, 3, "extension_signature"),
              "extended commit has an invalid extension signature"),
             (f"vote signature #{idx} altered", altered_ext(built.ext, idx, "signature"),
              f"extended commit votes failed verification: wrong signature (#{idx})"))
    with env_setting("TM_TPU_ENGINE", "off"):
        for label, ec, err in cases:
            # a refusal's failed RLC runs the cached bitmap (a fill where the
            # cache lacks the set's keys)
            want = {rlc: 2, **(bitmap_launches(vals, vals.size()) if err else {})}
            got, t = drive(f"phase 13: {kind} (c) {label}", lambda: check(ec), want, plane_totals,
                           rows=(rows, kind, vals.size() + n_ext))
            if (got is None) != (err is None) or (err and not str(got).startswith(err)):
                raise AssertionError(f"phase 13: {kind} (c) {label}: {got!r}, expected {err!r}")
            log(f"phase 13: {kind} (c) {vals.size()}-validator extended commit, {label}: "
                f"{'accepted' if got is None else 'refused (' + str(got)[:70] + ')'}, TM_TPU_ENGINE=off launches "
                f"{json.dumps(want)}, {t * 1e3:.2f} ms {on}")
    engine_totals = {}
    got, t = drive(f"phase 13: {kind} (c) honest through the engine", lambda: check(built.ext), {rlc: 2},
                   engine_totals, rows=(rows, kind, vals.size() + n_ext), merge=rlc)
    if got is not None:
        raise AssertionError(f"phase 13: {kind} (c) honest through the engine: {got!r}, expected None")
    for name, c in engine_totals.items():
        plane_totals[name] = plane_totals.get(name, 0) + c
    log(f"phase 13: {kind} (c) honest extended commit through the engine: accepted, launches "
        f"{json.dumps(engine_totals)} ({'the two batches coalesced' if engine_totals[rlc] == 1 else 'not coalesced'}"
        f"), {t * 1e3:.2f} ms {on}")

    # (d) the threaded sync over two routers and a MemoryNetwork
    node_d = state_node(m, src.gen, file_dbs(m, os.path.join(where, "d")))
    targets = [(m.reactor, "verify_commit_light", "light_sync", None),
               (m.reactor, "verify_commit_light_async", "ahead_dispatch", "ahead_wait"),
               (m.block.Block, "make_part_set", "make_part_set", None),
               (node_d.blocks, "save_block", "save_block", None),
               (node_d.executor, "apply_block", "apply_block", None),
               (src.node.blocks, "load_block", "load_block", None)]
    d_totals = {}
    with call_times(targets) as spent:
        (synced, state, t_caught), _ = drive(f"phase 13: {kind} (d) threaded sync",
                                             lambda: threaded_sync(m, src.node, node_d, chain_id),
                                             {rlc: launches_a}, d_totals, rows=(rows, kind, rows_a), merge=rlc)
    expect("(d) blocks synced", (synced, state.last_block_height), (top - 1, top - 1))
    for hh in range(1, top - 1):
        held_blocks(node_d, hh, "(d)")
    held(node_d, state, top - 1, "(d)")
    for name, c in d_totals.items():
        plane_totals[name] = plane_totals.get(name, 0) + c
    applied = [t1 for t1, _ in spent["apply_block"]]
    rate = (len(applied) - 1) / (applied[-1] - applied[0])

    def per_block(part):
        xs = [s * 1e3 for _, s in spent.get(part, [])]
        return (f"{part} {sum(xs) / (top - 1):.2f}" + (f" ({len(xs)} calls, {min(xs):.2f}-{max(xs):.2f})" if xs
                                                        else " (no calls)"))

    log(f"phase 13: {kind} (d) threaded sync of {top - 1} blocks over two routers: {rate:.2f} blocks/s (blocks 2-"
        f"{top - 1}: from the end of apply_block 1 to the end of apply_block {top - 1}), on_caught_up "
        f"{t_caught:.2f} s after the start (the pool's {m.bs_pool.STATUS_SETTLE_SECONDS:.1f} s settle window and "
        f"the {m.reactor.BlockSyncReactor.SWITCH_CHECK_INTERVAL:.1f} s switch check included), RLC launches "
        f"{d_totals[rlc]} carrying {rows_a} rows {on}")
    log(f"phase 13: {kind} (d) ms a synced block (sum / {top - 1}; calls, range a call): "
        + "; ".join(per_block(p) for p in SYNC_PARTS) + f" {on}")
    runs.append({"plane": kind, "commit": STATE_VALIDATORS, "run": "blocksync threaded, to on_caught_up",
                 "s": t_caught, "blocks_per_s": rate})
    for name, c in plane_totals.items():
        totals[name] = totals.get(name, 0) + c


# -- phase 14: consensus on one node -----------------------------------------------------------

CS_VALIDATORS = 150  # the Cosmos Hub's active set, as in phases 10-11
CS_HEIGHTS = 8
CS_NODE_PROPOSES_AT = 4  # the node's key is the proposer of round 0 at this height
CS_T0 = 1_700_600_000
CS_STEP_NS = 1_000_000  # the stepped clock's tick
CS_ADMIT = {3: "valid", 5: "tampered", 7: "small"}  # (b): each batch is admitted just before its height starts
CS_ENVELOPES = 1024  # (b): signed-tx envelopes from as many account keys
CS_TAMPER_ENVELOPE = 517
CS_SMALL_BATCH = 32  # below the device cutover
CS_TAMPER_INDEX = 77  # (c): the LastCommit signature a proposal carries altered
CS_BAD_VOTE_INDEX = 3  # (c): the validator whose prevote carries a bad signature
CS_CONFLICT_INDEX = 5  # (c): the validator that prevotes twice
CS_LIVE_TIMEOUT_S = 180
CS_JOIN_S = 30
# tests/test_consensus.py:25-39's fast timeouts, with bypass_commit_timeout: a live height's time is the node's work
CS_FAST_TIMEOUTS = {"propose": 400_000_000, "propose_delta": 200_000_000, "vote": 200_000_000,
                    "vote_delta": 100_000_000, "commit": 50_000_000, "bypass_commit_timeout": True}
CS_PARTS = ("add_vote", "validate_block", "process_proposal", "apply_block", "save_block", "wal_write", "wal_fsync",
            "create_proposal_block", "make_part_set")


def consensus_modules():
    """The port's modules a consensus node is built and driven with (those of
    state_modules and the consensus slice's); the functions below take such
    a namespace, so the CPU tests can hand them the JAX package's."""
    from tendermint_tpu_torch import metrics
    from tendermint_tpu_torch.consensus import handshake, messages, round_state, ticker, wal
    from tendermint_tpu_torch.consensus import state as cstate
    from tendermint_tpu_torch.crypto import ed25519, sr25519
    from tendermint_tpu_torch.mempool import mempool, preverify
    from tendermint_tpu_torch.privval import file_pv
    from tendermint_tpu_torch.types import proposal, vote_set

    return SimpleNamespace(**vars(state_modules()), metrics=metrics, handshake=handshake, messages=messages,
                           round_state=round_state, ticker=ticker, wal=wal, cstate=cstate, mempool=mempool,
                           preverify=preverify, file_pv=file_pv, proposal=proposal, vote_set=vote_set,
                           privs={"ed25519": ed25519.Ed25519PrivKey.generate, "sr25519": sr25519.Sr25519PrivKey})


class SteppedClock:
    """A ConsensusState's clock: each call returns a time CS_STEP_NS after the
    last; peek() the next one without stepping. Two nodes driven alike read
    the same times, so their votes, blocks and WAL records are byte-equal."""

    def __init__(self, m, t0_s=CS_T0 + 1):
        self.m, self.ns = m, t0_s * 10**9

    def __call__(self):
        t = self.peek()
        self.ns += CS_STEP_NS
        return t

    def peek(self):
        return self.m.tmtime.Time.from_unix_ns(self.ns)


class WallClock:
    """The wall clock as a SteppedClock's interface, for the live run."""

    def __init__(self, m):
        self.m = m

    def __call__(self):
        return self.m.tmtime.Time.now()

    peek = __call__


class SignerKey:
    """A validator key whose signatures come from sign(secrets, msgs) -> sigs
    (the CPU tests' memoizing signer, so that two packages' nodes sign the
    same bytes where signing is randomized)."""

    def __init__(self, m, member, sign):
        kind, pub, self.secret = member
        self.type_name, self._pub, self._sign = kind, m.keys[kind](pub), sign

    def pub_key(self):
        return self._pub

    def sign(self, msg):
        return self._sign([self.secret], [msg])[0]


class ManualTicker:
    """Captures the timeouts a ConsensusState schedules; its driver fires them
    (tests/test_consensus_locking.py's)."""

    def __init__(self):
        self.scheduled = []

    def schedule_timeout(self, ti):
        self.scheduled.append(ti)

    def stop(self):
        pass


def cs_genesis(m, members, chain_id, fast=False):
    """The GenesisDoc of members [(kind, pub, secret)] at power 10 each;
    `fast` sets CS_FAST_TIMEOUTS."""
    import dataclasses

    kinds = tuple(sorted({kind for kind, _, _ in members}))
    params = m.params.ConsensusParams(validator=m.params.ValidatorParams(pub_key_types=kinds))
    if fast:
        params = dataclasses.replace(params, timeout=m.params.TimeoutParams(**CS_FAST_TIMEOUTS))
    doc = m.genesis.GenesisDoc(
        chain_id=chain_id, genesis_time=m.tmtime.Time(CS_T0, 0), consensus_params=params,
        validators=[m.genesis.GenesisValidator(address=m.keys[kind](pub).address(), pub_key=m.keys[kind](pub),
                                               power=10, name=f"v{i}")
                    for i, (kind, pub, _) in enumerate(members)])
    doc.validate_and_complete()
    return doc


def proposer_schedule(m, gen, heights):
    """The address proposing round 0 of each height 1..heights, the set
    unchanged."""
    vals, out = m.state.make_genesis_state(gen).validators.copy(), []
    for _ in range(heights):
        out.append(vals.get_proposer().address)
        vals.increment_proposer_priority(1)
    return out


def node_member(m, gen, members, at=CS_NODE_PROPOSES_AT):
    """The index among members of the key proposing round 0 of height `at`."""
    addr = proposer_schedule(m, gen, at)[-1]
    return next(i for i, (kind, pub, _) in enumerate(members) if m.keys[kind](pub).address() == addr)


def cs_stores(m, gen, dbs, device=None, app_db=None):
    """A node's app (the kvstore through LocalClient), state store, block
    store, evidence pool, TxMempool with EngineTxPreVerifier and
    BlockExecutor over dbs {"app", "state", "blocks", "evidence"}, brought to
    its block store's height by the Handshaker (InitChain on a fresh one);
    `device` is passed on unless None (the JAX package's take none)."""
    kw = {} if device is None else {"device": device}
    client = m.abci.LocalClient(m.kvstore.KVStoreApplication(dbs["app"]))
    states = m.state.StateStore(dbs["state"])
    blocks = m.blockstore.BlockStore(dbs["blocks"])
    state = states.load()
    if state is None:
        state = m.state.make_genesis_state(gen)
        states.save(state)
    handshaker = m.handshake.Handshaker(states, state, blocks, gen, **kw)
    state = handshaker.handshake(client)
    registry = m.metrics.Registry()
    pool = m.pool.EvidencePool(dbs["evidence"], states, blocks, **kw)
    mempool = m.mempool.TxMempool(client, metrics=m.metrics.MempoolMetrics(registry),
                                  pre_verify=m.preverify.EngineTxPreVerifier(**kw))
    executor = m.execution.BlockExecutor(states, client, mempool=mempool, evidence_pool=pool, block_store=blocks, **kw)
    return SimpleNamespace(client=client, states=states, blocks=blocks, pool=pool, mempool=mempool,
                           executor=executor, state=state, handshaker=handshaker, registry=registry, dbs=dbs)


def cs_node(m, gen, dbs, priv_key, where, clock, device=None):
    """The node under test: cs_stores' layers, a FilePV over priv_key whose
    last-sign state is a file in `where`, a WAL on disk in `where`, and a
    ConsensusState over them with `clock`, its broadcasts collected in
    .out and what on_fatal receives in .fatal."""
    node = cs_stores(m, gen, dbs, device)
    lss = m.file_pv.LastSignState.load(os.path.join(where, "priv_validator_state.json"))
    node.pv = m.file_pv.FilePV(priv_key=priv_key, last_sign_state=lss)
    node.wal_path = os.path.join(where, "cs.wal")
    node.out, node.fatal, node.decided = [], [], []
    node.cs = m.cstate.ConsensusState(
        node.state, node.executor, node.blocks, priv_validator=node.pv, wal=m.wal.WAL(node.wal_path),
        evidence_pool=node.pool, broadcast=node.out.append, clock=clock,
        on_decided=lambda h, b, bid: node.decided.append((h, time.perf_counter())),
        metrics=m.metrics.ConsensusMetrics(node.registry), on_fatal=node.fatal.append, mempool=node.mempool)
    return node


def commit_keys(vals, commit):
    """The keys of a commit's rows as verify_commit batches them: every
    signature that is not absent."""
    return [vals.validators[i].pub_key.bytes() for i, s in enumerate(commit.signatures) if not s.absent()]


def tampered_envelope(tx):
    """A signed-tx envelope (mempool/preverify.py's layout: magic, public
    key, signature, payload) with the last byte of its signature flipped."""
    from tendermint_tpu_torch.mempool.preverify import SIGTX_MAGIC

    at = len(SIGTX_MAGIC) + 32 + 63
    return tx[:at] + bytes([tx[at] ^ 1]) + tx[at + 1:]


class ConsensusNet:
    """The other validators of a consensus node's set, played by hand on the
    caller's thread, as tests/test_consensus_locking.py:60-190's Driver does:
    proposals built with create_proposal_block and signed with their
    proposer's key, and every other validator's prevotes and precommits,
    through sign(secrets, msgs) -> sigs. The node runs under a manual ticker;
    each of its calls (messages queued through add_peer_message, or a fired
    timeout, then process_all) goes through step(label, fn, want), where want
    lists the device checks the call makes: ("rows", keys, valid). A shadow
    replica (cs_stores over its own stores) applies each decided block under
    TM_TPU_CRYPTO=off (no launch), for the app hash and state the height must
    reach."""

    def __init__(self, m, node, members, sign, chain_id, clock, step=None, shadow=None, manual=True):
        self.m, self.node, self.cs, self.sign, self.chain_id, self.clock = m, node, node.cs, sign, chain_id, clock
        self.secrets = member_secrets(m, members)
        self.me = node.pv.get_pub_key().address()
        self.step = step or (lambda label, fn, want: (fn(), 0.0))
        self.shadow = shadow
        # the network's proposals are built by an executor of their own over
        # the node's stores and mempool (create_proposal_block checks nothing)
        self.builder = m.execution.BlockExecutor(node.states, node.client, mempool=node.mempool,
                                                 evidence_pool=node.pool, block_store=node.blocks)
        self.precommits = {}  # height -> {validator index: precommit}, the node's included
        self.records = []
        self.replay_want = []  # the device checks of the records after the last EndHeight, in order
        if manual:
            self.ticker = ManualTicker()
            self.cs.ticker = self.ticker
            self.cs._schedule_round_0()

    # -- the node's calls

    def call(self, label, send, want=()):
        def run():
            send()
            self.cs.process_all(0)
        return self.step(label, run, list(want))

    def fire(self, step_, round_=0):
        """Queue the last timeout scheduled for (the node's height, round_, step_)."""
        h = self.cs.rs.height
        ti = next(t for t in reversed(self.ticker.scheduled) if (t.height, t.round, t.step) == (h, round_, step_))
        return lambda: self.cs._tock(ti)

    def deliver(self, msgs, peer="net"):
        msgs = list(msgs)
        return lambda: [self.cs.add_peer_message(msg, peer) for msg in msgs]

    # -- what the network sends

    def votes(self, type_, height, round_, block_id, skip=()):
        """Every other validator's signed vote (those at indices in skip left out)."""
        vals = self.cs.state.validators
        t = self.clock.peek()
        out = [self.m.vote.Vote(type=type_, height=height, round=round_, block_id=block_id, timestamp=t,
                                validator_address=v.address, validator_index=i)
               for i, v in enumerate(vals.validators) if v.address != self.me and i not in skip]
        sigs = self.sign([self.secrets[v.validator_address] for v in out], [v.sign_bytes(self.chain_id) for v in out])
        for v, sig in zip(out, sigs):
            v.signature = sig
        return out

    def last_commit(self, height):
        """The LastCommit a proposal at `height` carries: every precommit of
        height - 1 (the node's included)."""
        if height == self.cs.state.initial_height:
            return self.m.block.Commit()
        pcs = self.precommits[height - 1]
        first = next(iter(pcs.values()))
        return self.m.block.Commit(height=height - 1, round=first.round, block_id=first.block_id,
                                   signatures=[pcs[i].to_commit_sig() for i in range(len(pcs))])

    def want(self, height, commit=None, valid=True):
        """The device check of validating a proposal at `height` (its LastCommit's rows)."""
        if height == self.cs.state.initial_height:
            return []
        commit = commit or self.last_commit(height)
        return [("rows", commit_keys(self.cs.state.last_validators, commit), valid)]

    def proposal(self, height, round_, last_commit=None, proposer=None):
        """The block the proposer of (height, round_) builds from the node's
        state, its ID, and its signed proposal and parts as messages."""
        m, st = self.m, self.cs.state
        proposer = proposer or self.cs.rs.validators.get_proposer().address
        assert proposer != self.me
        block = self.builder.create_proposal_block(height, st, last_commit or self.last_commit(height), proposer,
                                                        block_time=self.clock.peek())
        parts = block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES)
        bid = m.block.BlockID(block.hash(), parts.header)
        prop = m.proposal.Proposal(height=height, round=round_, pol_round=-1, block_id=bid,
                                   timestamp=block.header.time)
        prop.signature = self.sign([self.secrets[proposer]], [prop.sign_bytes(self.chain_id)])[0]
        return block, bid, [m.messages.ProposalMessage(prop)] + [
            m.messages.BlockPartMessage(height, round_, parts.get_part(i)) for i in range(parts.total())]

    # -- what the node did

    def our_vote(self, type_, height, round_):
        for msg in reversed(self.node.out):
            v = getattr(msg, "vote", None)
            if v is not None and (v.type, v.height, v.round) == (type_, height, round_) and v.validator_address == self.me:
                return v
        return None

    def our_proposal(self, height, round_):
        for msg in reversed(self.node.out):
            p = getattr(msg, "proposal", None)
            if p is not None and (p.height, p.round) == (height, round_):
                return p
        return None

    # -- a height

    def height(self, h, admit=None):
        """Drive height h to its commit in round 0: (b)'s admission batch
        first where one is given (label, txs, want), then the NEW_HEIGHT
        timeout, the proposal (the node's own, or the network's), every
        other prevote, every other precommit. Returns the height's record."""
        m, cs = self.m, self.cs
        P, PC = m.vote.PREVOTE, m.vote.PRECOMMIT
        assert cs.rs.height == h, (cs.rs.height, h)
        outcomes = []
        if admit is not None:
            label, txs, want = admit
            self.call(f"height {h}: admission of {label}",
                      lambda: outcomes.extend(self.node.mempool.check_tx_batch(txs)), want)
        ours = cs.rs.validators.get_proposer().address == self.me
        want = self.want(h)
        self.call(f"height {h}: the NEW_HEIGHT timeout" + (", the node proposes" if ours else ""),
                  self.fire(m.round_state.STEP_NEW_HEIGHT), want if ours else [])
        if ours:
            bid = self.our_proposal(h, 0).block_id
        else:
            _, bid, msgs = self.proposal(h, 0)
            self.call(f"height {h}: the proposal and its {len(msgs) - 1} parts", self.deliver(msgs), want)
        prevote = self.our_vote(P, h, 0)
        assert prevote is not None and prevote.block_id == bid, f"height {h}: the node did not prevote the proposal"
        self.call(f"height {h}: the other prevotes", self.deliver(m.messages.VoteMessage(v)
                                                                   for v in self.votes(P, h, 0, bid)))
        precommit = self.our_vote(PC, h, 0)
        assert precommit is not None and precommit.block_id == bid, f"height {h}: the node did not precommit"
        pcs = self.votes(PC, h, 0, bid)
        self.precommits[h] = {v.validator_index: v for v in pcs + [precommit]}
        self.call(f"height {h}: the other precommits", self.deliver(m.messages.VoteMessage(v) for v in pcs))
        assert cs.rs.height == h + 1 and self.node.blocks.height() == h, f"height {h} was not committed"
        block = self.node.blocks.load_block(h)
        assert block.hash() == bid.hash
        rec = SimpleNamespace(height=h, block_id=(bid.hash, bid.part_set_header.total, bid.part_set_header.hash), ours=ours, block=block.to_proto().encode(),
                              app_hash=cs.state.app_hash, state=m.state_store.state_to_json(cs.state),
                              votes=(prevote.to_proto().encode(), precommit.to_proto().encode()),
                              outcomes=outcomes, txs=list(block.txs), mempool=self.node.mempool.size())
        if self.shadow is not None:
            with env_setting("TM_TPU_CRYPTO", "off"):
                self.shadow.state = self.shadow.executor.apply_block(self.shadow.state, bid, block)
            assert rec.app_hash == self.shadow.state.app_hash, f"height {h}: app hash off the shadow's"
            assert rec.state == m.state_store.state_to_json(self.shadow.state), f"height {h}: state off the shadow's"
        self.records.append(rec)
        return rec

    # -- (c): refusals at the next height

    def refusals(self, fault=None):
        """At height h = the node's: the NEW_HEIGHT timeout; a proposal whose
        LastCommit has signature CS_TAMPER_INDEX altered (a nil prevote, the
        reference's error naming the index); a prevote with a bad signature
        (dropped on the host); a validator's two prevotes for two block IDs
        (report_conflicting_votes); then round 0 closed on nil votes. Where
        `fault` is given (a context manager making the device entry points
        raise), round 1's honest proposal is delivered through the node's
        consumer routine inside it: on_fatal must receive the fault and no
        prevote of round 1 be signed. Returns what was seen."""
        import copy
        import threading

        m, cs, node, P, PC = self.m, self.cs, self.node, self.m.vote.PREVOTE, self.m.vote.PRECOMMIT
        h, n = cs.rs.height, cs.state.validators.size()
        others = [i for i, v in enumerate(cs.state.validators.validators) if v.address != self.me]
        bad_i, conflict_i = others[CS_BAD_VOTE_INDEX % len(others)], others[CS_CONFLICT_INDEX % len(others)]
        assert bad_i != conflict_i
        self.replay_want = []
        self.call(f"(c) height {h}: the NEW_HEIGHT timeout", self.fire(m.round_state.STEP_NEW_HEIGHT))
        honest = self.last_commit(h)
        bad, ti = copy.deepcopy(honest), min(CS_TAMPER_INDEX, n - 1)
        bad.signatures[ti].signature = tamper(bad.signatures[ti].signature)
        errors, reported = [], []
        real_validate, real_report = node.executor.validate_block, node.pool.report_conflicting_votes

        def validate(state, block):
            try:
                return real_validate(state, block)
            except Exception as e:
                errors.append(e)
                raise

        node.executor.validate_block = validate
        node.pool.report_conflicting_votes = lambda a, b: (reported.append((a, b)), real_report(a, b))
        try:
            _, bad_bid, msgs = self.proposal(h, 0, last_commit=bad)
            self.replay_want += self.want(h, bad, valid=False)
            self.call(f"(c) height {h}: a proposal whose LastCommit has signature #{ti} altered",
                      self.deliver(msgs), self.want(h, bad, valid=False))
            prevote = self.our_vote(P, h, 0)
            assert prevote is not None and prevote.block_id.is_nil(), "the altered LastCommit was not prevoted nil"
            (forged,) = self.votes(P, h, 0, bad_bid, skip=[i for i in range(n) if i != bad_i])
            forged.signature = tamper(forged.signature)
            self.call(f"(c) height {h}: a prevote with a bad signature", self.deliver([m.messages.VoteMessage(forged)]))
            skip = [i for i in range(n) if i != conflict_i]
            (first,) = self.votes(P, h, 0, bad_bid, skip=skip)
            (second,) = self.votes(P, h, 0, m.block.BlockID(), skip=skip)
            self.call(f"(c) height {h}: a validator's two prevotes", self.deliver(
                [m.messages.VoteMessage(first), m.messages.VoteMessage(second)]))
        finally:
            node.executor.validate_block, node.pool.report_conflicting_votes = real_validate, real_report
        held = {v.validator_index for v in cs.rs.votes.prevotes(0).list()}
        seen = SimpleNamespace(error=f"{error_name(errors[0])}: {errors[0]}" if errors else None,
                               nil_prevote=prevote.to_proto().encode(), forged_dropped=bad_i not in held,
                               reported=[(a.validator_index, b.validator_index) for a, b in reported],
                               tamper_index=ti, bad_index=bad_i, conflict_index=conflict_i)
        # close round 0 on nil: every other validator prevotes nil (the one
        # whose second prevote conflicted has voted) and precommits nil
        nil = m.block.BlockID()
        skip = (conflict_i,)
        self.call(f"(c) height {h}: nil prevotes", self.deliver(m.messages.VoteMessage(v)
                                                               for v in self.votes(P, h, 0, nil, skip=skip)))
        self.call(f"(c) height {h}: nil precommits", self.deliver(m.messages.VoteMessage(v)
                                                                 for v in self.votes(PC, h, 0, nil)))
        self.call(f"(c) height {h}: the PRECOMMIT_WAIT timeout", self.fire(m.round_state.STEP_PRECOMMIT_WAIT))
        assert cs.rs.round == 1, f"height {h} did not move to round 1"
        if fault is None:
            return seen
        _, _, msgs = self.proposal(h, 1)
        self.replay_want += self.want(h)
        for msg in msgs:
            cs.add_peer_message(msg, "net")

        def consume():
            try:
                cs._receive_routine()
            except Exception:
                pass  # on_fatal has it

        def run():
            t = threading.Thread(target=consume, name="consensus", daemon=True)
            t.start()
            t.join(CS_JOIN_S)
            assert not t.is_alive(), "the consumer routine did not stop on the fault"

        with fault:
            self.step(f"(c) height {h}: round 1's proposal with the device entry points failing", run, [])
        seen.fatal = [f"{type(e).__name__}: {e}" for e in node.fatal]
        seen.prevote_r1 = self.our_vote(P, h, 1)
        return seen


def cs_restart(m, net, gen, priv_key, clock, device=None, step=None):
    """(d): a fresh state store at genesis and a fresh kvstore replay the
    node's stored heights through the Handshaker (apply_block a height);
    then, the WAL's tail torn by a partial write, a second ConsensusState on
    the same WAL, block store, last-sign state and the replayed state repairs
    the WAL and replays it from the last EndHeight. Returns (the handshake's
    state, its n_blocks, the WAL clean before, after, the second node)."""
    node = net.node
    step = step or (lambda label, fn, want: (fn(), 0.0))
    node.cs.wal.close()
    with open(node.wal_path, "ab") as f:
        f.write(b"\x07\x00\x00\x00torn")
    kw = {} if device is None else {"device": device}
    dbs = {"app": m.kv.MemDB(), "state": m.kv.MemDB(), "evidence": m.kv.MemDB()}
    client = m.abci.LocalClient(m.kvstore.KVStoreApplication(dbs["app"]))
    states = m.state.StateStore(dbs["state"])
    genesis_state = m.state.make_genesis_state(gen)
    states.save(genesis_state)
    handshaker = m.handshake.Handshaker(states, genesis_state, node.blocks, gen, **kw)
    stored = node.blocks.height()
    want = [("rows", commit_keys(node.states.load_validators(h - 1), node.blocks.load_block(h).last_commit), True)
            for h in range(2, stored + 1)]
    state, _ = step(f"(d) the handshake's replay of {stored} stored heights", lambda: handshaker.handshake(client),
                    want)
    pool = m.pool.EvidencePool(dbs["evidence"], states, node.blocks, **kw)
    executor = m.execution.BlockExecutor(states, client, evidence_pool=pool, block_store=node.blocks, **kw)
    pv = m.file_pv.FilePV(priv_key=priv_key, last_sign_state=m.file_pv.LastSignState.load(node.pv.last_sign_state.file_path))
    wal = m.wal.WAL(node.wal_path)
    _, clean_before = wal.search_for_end_height_with_status(stored)
    out = []
    cs2 = m.cstate.ConsensusState(state, executor, node.blocks, priv_validator=pv, wal=wal, evidence_pool=pool,
                                  broadcast=out.append, clock=clock)
    cs2.ticker = ManualTicker()
    step("(d) the second node's WAL repair and replay", cs2._catchup_replay, net.replay_want)
    _, clean_after = wal.search_for_end_height_with_status(stored)
    cs2.out = out
    return state, handshaker.n_blocks, clean_before, clean_after, cs2


def cs_expected(P, dev, want, present=None):
    """The launches a node call must make from the device checks it runs,
    want [("rows", keys, valid)]: below the device cutover a check runs on
    the host; at or above the MSM cutover the RLC, then on a bad batch the
    bitmap plane; the bitmap plane up to the cache's capacity is the cached
    bitmap: a fill when a key is missing from the plane's cache (`present`,
    its keys as the call found them, by default as they are now; keys an
    earlier check of the call filled count as present), then a hit."""
    from tendermint_tpu_torch.crypto import ed25519 as ted

    cache = P.cache(dev)
    present, out = set(cache._lru if present is None else present), {}

    def add(fn):
        out[fn.__name__] = out.get(fn.__name__, 0) + 1

    for _, keys, valid in want:
        if len(keys) < ted.DEVICE_BATCH_CUTOVER:
            continue
        if len(keys) >= ted.MSM_BATCH_CUTOVER:
            add(P.rlc)
            if valid:
                continue
        if len(set(keys)) > cache.capacity:
            add(P.bitmap)
            continue
        if any(k not in present for k in keys):
            add(P.fill)
            present.update(keys)
        add(P.hit)
    return out


@contextlib.contextmanager
def failing_entries(message, exc=ValueError):
    """Every device entry point of both planes (the bitmaps, the cached
    bitmaps, the RLCs) raising exc(message): by default a kernel wrapper's
    ValueError; a RuntimeError stands for a failed build or launch."""
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.ops import verify_sr as VS

    def fail(*a, **k):
        raise exc(message)

    saved = [(mod, name, getattr(mod, name)) for mod, names in (
        (V, ("verify_batch_async", "verify_batch_cached_async")),
        (VS, ("verify_batch_async", "verify_batch_cached_async")),
        (M, ("verify_batch_rlc_async", "verify_batch_rlc_cached_async", "verify_batch_rlc_sr_async")))
        for name in names]
    for mod, name, _ in saved:
        setattr(mod, name, fail)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


@contextlib.contextmanager
def thread_times(targets, thread="consensus"):
    """Each call of the targets [(object, attribute, part)] made on the
    thread named `thread`, timed into the yielded {part: seconds}, and the
    thread's CPU time in those calls into {part + "_cpu": seconds} (CPU
    time leaves out waits: for the GIL, a lock, an fsync)."""
    import threading

    parts = {part for _, _, part in targets}
    spent = dict.fromkeys(list(parts) + [part + "_cpu" for part in parts], 0.0)

    def timed(real, part):
        def call(*a, **k):
            if threading.current_thread().name != thread:
                return real(*a, **k)
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return real(*a, **k)
            finally:
                spent[part] += time.perf_counter() - t0
                spent[part + "_cpu"] += time.thread_time() - c0
        return call

    saved = []
    for obj, name, part in targets:
        raw = obj.__dict__[name] if isinstance(obj, type) else None
        if isinstance(raw, classmethod):
            saved.append((obj, name, raw))
            setattr(obj, name, staticmethod(timed(getattr(obj, name), part)))
        else:
            real = raw if raw is not None else getattr(obj, name)
            saved.append((obj, name, raw if raw is not None else None))
            setattr(obj, name, timed(real, part))
    try:
        yield spent
    finally:
        for obj, name, raw in saved:
            if raw is None:
                delattr(obj, name)  # the instance attribute; the class's method shows again
            else:
                setattr(obj, name, raw)


def cs_parts(m, node):
    """thread_times' targets for a node's consensus thread: CS_PARTS, and its
    whole busy time ("node": every input it dispatched)."""
    return [(m.vote_set.VoteSet, "add_vote", "add_vote"), (node.executor, "validate_block", "validate_block"),
            (node.executor, "process_proposal", "process_proposal"), (node.executor, "apply_block", "apply_block"),
            (node.blocks, "save_block", "save_block"), (node.cs.wal, "write", "wal_write"),
            (node.cs.wal, "write_sync", "wal_fsync"), (node.cs.wal, "flush_and_sync", "wal_fsync"),
            (node.executor, "create_proposal_block", "create_proposal_block"),
            (m.part_set.PartSet, "from_data", "make_part_set"), (node.cs, "_dispatch", "node")]


def live_run(m, gen, members, priv_key, sign, chain_id, where, heights=CS_HEIGHTS, device=None,
             timeout=CS_LIVE_TIMEOUT_S):
    """(e): a node over fresh stores started with start() and the real
    ticker and clock; the network answers its broadcasts from a thread of
    its own (the proposal of another proposer as the node enters round 0's
    propose step, every other prevote when the node prevotes a block, every
    other precommit when it precommits one), until the node has decided
    `heights` heights. Returns (decided [(height, perf_counter)], the start's
    perf_counter, the split {part: seconds} of the node's consensus thread,
    with "node" its whole busy time (every input it dispatched), "node_cpu"
    the thread's CPU time in it, and "network"
    the seconds the network's thread spent building, signing and delivering
    its answers, during which the node waits)."""
    import queue
    import threading

    dbs = {name: m.kv.MemDB() for name in ("app", "state", "blocks", "evidence")}
    clock = WallClock(m)
    node = cs_node(m, gen, dbs, priv_key, where, clock, device)
    net = ConsensusNet(m, node, members, sign, chain_id, clock, manual=False)
    schedule = proposer_schedule(m, gen, heights + 1)
    inbox, stop, done, errors = queue.Queue(), threading.Event(), threading.Event(), []
    node.cs.broadcast = inbox.put
    node.cs.on_decided = lambda h, b, bid: (node.decided.append((h, time.perf_counter())),
                                            h >= heights and done.set())
    Msgs, P, PC = m.messages, m.vote.PREVOTE, m.vote.PRECOMMIT
    network = [0.0]

    def answer():
        proposed = set()
        try:
            while not stop.is_set():
                try:
                    msg = inbox.get(timeout=0.05)
                except queue.Empty:
                    continue
                t_msg = time.perf_counter()
                if (isinstance(msg, Msgs.NewRoundStepMessage) and msg.step == m.round_state.STEP_PROPOSE
                        and msg.round == 0 and msg.height not in proposed and msg.height <= heights):
                    proposed.add(msg.height)
                    if schedule[msg.height - 1] != net.me:
                        for out in net.proposal(msg.height, 0, proposer=schedule[msg.height - 1])[2]:
                            node.cs.add_peer_message(out, "net")
                elif isinstance(msg, Msgs.VoteMessage) and msg.vote.validator_address == net.me:
                    v = msg.vote
                    if v.round != 0 or v.block_id.is_nil():
                        raise AssertionError(f"the node voted {v.type} for nil at {v.height}/{v.round}")
                    others = net.votes(v.type, v.height, 0, v.block_id)
                    if v.type == PC:
                        net.precommits[v.height] = {o.validator_index: o for o in others + [v]}
                    for o in others:
                        node.cs.add_peer_message(Msgs.VoteMessage(o), "net")
                network[0] += time.perf_counter() - t_msg
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            errors.append(e)
            done.set()

    driver = threading.Thread(target=answer, name="net", daemon=True)
    with thread_times(cs_parts(m, node)) as spent:
        driver.start()
        t0 = time.perf_counter()
        node.cs.start()
        try:
            finished = done.wait(timeout)
        finally:
            node.cs.stop()
            stop.set()
            driver.join(CS_JOIN_S)
    if errors:
        raise errors[0]
    if node.fatal:
        raise node.fatal[0]
    if not finished or driver.is_alive():
        raise AssertionError(f"the live run stopped at height {node.blocks.height()} of {heights}")
    return node.decided, t0, dict(spent, network=network[0])


def consensus_setup(pool, rng, chain_id):
    """Phase 14's keys and envelopes, at set-up: on each plane CS_VALIDATORS
    validators' keys; for ed25519's (b), CS_ENVELOPES account keys, each
    signing two kv transactions (the first batch's and the second's), the
    first CS_SMALL_BATCH a third, wrapped as signed-tx envelopes."""
    out = {}
    for kind in PLANES:
        seeds = [rng.bytes(32) for _ in range(CS_VALIDATORS)]
        out[kind] = SimpleNamespace(members=[(kind, pub, (kind, seed))
                                             for seed, pub in zip(seeds, make_keys(pool, kind, seeds))])
    payload = lambda i, r: b"acct-%d=n%d" % (i, r)
    seeds = [rng.bytes(32) for _ in range(CS_ENVELOPES)]
    rounds = lambda i: [1, 2] + ([3] if i < CS_SMALL_BATCH else []) + ([4] if i < NET_FAULT_ENVELOPES else [])
    jobs = [("ed25519", s, [payload(i, r) for r in rounds(i)]) for i, s in enumerate(seeds)]
    signed = pool.map(_sign_worker, jobs, chunksize=64)
    from tendermint_tpu_torch.mempool.preverify import SIGTX_MAGIC

    env = lambda r: [(pub, SIGTX_MAGIC + pub + sigs[rounds(i).index(r)] + payload(i, r))
                     for i, (pub, sigs) in enumerate(signed) if r in rounds(i)]
    # "fault": phase 15 (e)'s fresh batch
    out["ed25519"].batches = {"valid": env(1), "tampered": env(2), "small": env(3), "fault": env(4)}
    return out


def admission_batch(label, batch):
    """(b)'s admission of one batch [(pub, envelope)] as ConsensusNet.height
    takes it: the label, the txs (the tampered batch's CS_TAMPER_ENVELOPE-th
    signature altered) and the device check of its pre-verification."""
    txs = [tx for _, tx in batch]
    if label == "tampered":
        txs[CS_TAMPER_ENVELOPE] = tampered_envelope(txs[CS_TAMPER_ENVELOPE])
    return (f"{len(txs)} envelopes ({label})", txs, [("rows", [pub for pub, _ in batch], label != "tampered")])


def consensus_phase(planes, chain_id, built, runs, tmp, sign):
    """Phase 14 on each plane: (a) the deterministic drive of CS_HEIGHTS
    heights, (b) the admission batches (ed25519), (c) the refusals, (d) the
    restart, (e) the live run; every call of the node held to its launches.
    The network signs with `sign`, on the process pool phases 14-16 share."""
    m = consensus_modules()
    totals = {}
    for kind, P in planes.items():
        _consensus_plane(m, kind, P, chain_id, built[kind], sign, runs, totals, os.path.join(tmp, kind))
    check_path("phase 14", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()]
               + [{P.rlc.__name__: 1} for kind, P in planes.items() if kind == "ed25519"])
    return totals


def _consensus_plane(m, kind, P, chain_id, built, sign, runs, totals, where):
    import torch

    dev = torch.device("cuda", 0)
    members = built.members
    gen = cs_genesis(m, members, chain_id)
    ni = node_member(m, gen, members)
    priv = m.privs[kind](members[ni][2][1])
    clock = SteppedClock(m)
    os.makedirs(os.path.join(where, "node"))
    node = cs_node(m, gen, file_dbs(m, os.path.join(where, "node")), priv, os.path.join(where, "node"), clock, dev)
    shadow = cs_stores(m, gen, {name: m.kv.MemDB() for name in ("app", "state", "blocks", "evidence")}, dev)
    calls = []

    def step(label, fn, want):
        expected = cs_expected(P, dev, want)
        out, t = drive(f"phase 14: {kind} {label}", fn, expected, totals)
        calls.append((label, t, expected))
        return out, t

    # (a) and (b)
    net = ConsensusNet(m, node, members, sign, chain_id, clock, step, shadow)
    batches = getattr(built, "batches", {})
    for h in range(1, CS_HEIGHTS + 1):
        label = CS_ADMIT.get(h)
        admit = admission_batch(label, batches[label]) if label in batches else None
        n0 = len(calls)
        rec = net.height(h, admit)
        if admit is not None:
            oks = [o.code == 0 for o in rec.outcomes]
            bad = [i for i, ok in enumerate(oks) if not ok]
            want_bad = [CS_TAMPER_ENVELOPE] if label == "tampered" else []
            if bad != want_bad or (bad and rec.outcomes[bad[0]].log != "tx signature pre-verification failed"):
                raise AssertionError(f"phase 14: {kind} (b) {label}: refused {bad}, expected {want_bad}")
            # the height's proposal reaped them; its commit removed them from the mempool
            if not {tx for tx, ok in zip(admit[1], oks) if ok} <= set(rec.txs) or rec.mempool != 0:
                raise AssertionError(f"phase 14: {kind} (b) height {h} did not commit the admitted txs "
                                     f"({len(rec.txs)} txs in the block, {rec.mempool} left in the mempool)")
        log(f"phase 14: {kind} (a) height {h}: {'the node' if rec.ours else 'the network'} proposed "
            f"{rec.block_id[0].hex()[:16]} with {len(rec.txs)} txs, app hash {rec.app_hash.hex()}, as the "
            f"shadow's; calls ms: " + json.dumps({c[0].split(': ', 1)[1]: [round(c[1] * 1e3, 2), c[2]]
                                                  for c in calls[n0:]}))
    wal = m.wal.WAL(node.wal_path)
    missing = [h for h in range(1, CS_HEIGHTS + 1) if wal.search_for_end_height(h) is None]
    wal.close()
    if missing:
        raise AssertionError(f"phase 14: {kind} the WAL has no EndHeight for {missing}")
    # (c)
    msg = f"no kernel for device {dev}"
    seen = net.refusals(fault=failing_entries(msg))
    want_err = f"ValueError: wrong signature (#{seen.tamper_index}):"
    if not (seen.error or "").startswith(want_err) or not seen.forged_dropped \
            or seen.reported != [(seen.conflict_index, seen.conflict_index)] \
            or seen.fatal != [f"ValueError: {msg}"] or seen.prevote_r1 is not None:
        raise AssertionError(f"phase 14: {kind} (c) refusals: {seen}")
    log(f"phase 14: {kind} (c) the altered LastCommit prevoted nil ({seen.error[:60]}...); the forged prevote "
        f"of validator {seen.bad_index} dropped; validator {seen.conflict_index}'s conflicting prevotes reported; "
        f"with the device entry points failing, on_fatal got {seen.fatal} and no prevote of round 1 was signed")
    # (d)
    state, n_blocks, clean_before, clean_after, cs2 = cs_restart(m, net, gen, priv, clock, dev, step)
    if (state.app_hash != node.cs.state.app_hash or n_blocks != CS_HEIGHTS or clean_before or not clean_after
            or m.state_store.state_to_json(state) != m.state_store.state_to_json(node.cs.state)
            or (cs2.rs.height, cs2.rs.round) != (CS_HEIGHTS + 1, 1)):
        raise AssertionError(f"phase 14: {kind} (d) restart: n_blocks {n_blocks}, WAL clean {clean_before} -> "
                             f"{clean_after}, at {cs2.rs.height}/{cs2.rs.round}")
    cs2.wal.close()
    log(f"phase 14: {kind} (d) the handshake replayed {n_blocks} heights to the node's app hash and state; the "
        f"second node repaired the torn WAL and replayed it to {cs2.rs.height}/{cs2.rs.round}; calls ms: "
        + json.dumps({c[0]: [round(c[1] * 1e3, 2), c[2]] for c in calls[-2:]}))
    # (e)
    live_gen = cs_genesis(m, members, chain_id + "-live", fast=True)
    live_priv = m.privs[kind](members[node_member(m, live_gen, members)][2][1])
    keys = [k for _, k, _ in members]
    os.makedirs(os.path.join(where, "live"))
    (decided, t0, spent), t = drive(
        f"phase 14: {kind} (e) live run", lambda: live_run(m, live_gen, members, live_priv, sign, chain_id + "-live",
                                                           os.path.join(where, "live"), device=dev),
        cs_expected(P, dev, [("rows", keys, True)] * (CS_HEIGHTS - 1)), totals)
    hps = CS_HEIGHTS / (decided[-1][1] - t0)
    split = {part: round(spent.get(part, 0.0) * 1e3 / CS_HEIGHTS, 2) for part in CS_PARTS}
    split["rest"] = round((spent["node"] - sum(spent[part] for part in CS_PARTS)) * 1e3 / CS_HEIGHTS, 2)
    # the wall clock's heights/s counts the network stand-in's work too; the
    # node's own time a height is its consensus thread's busy time (with its
    # CPU time, which leaves out the GIL it waits for while the stand-in runs)
    log(f"phase 14: {kind} (e) live run of {CS_HEIGHTS} heights over {len(members)} validators: {hps:.2f} heights/s "
        f"({(decided[-1][1] - t0) * 1e3:.1f} ms); the node busy {spent['node'] * 1e3 / CS_HEIGHTS:.2f} ms a height "
        f"({CS_HEIGHTS / spent['node']:.2f} node-only heights/s), its CPU {spent['node_cpu'] * 1e3 / CS_HEIGHTS:.2f} "
        f"ms a height; the network stand-in's {spent['network'] * 1e3 / CS_HEIGHTS:.2f} ms a height; the node's "
        f"ms a height: {json.dumps(split)} on {card()}")
    runs.append({"plane": kind, "run": "consensus (e)", "commit": len(members), "s": decided[-1][1] - t0,
                 "heights_per_s": hps, "node_s": spent["node"], "node_cpu_s": spent["node_cpu"],
                 "network_s": spent["network"]})


# -- phase 15: a 150-validator network of node processes over TCP ------------

NET_NODES = 4
NET_HEIGHTS = {"ed25519": 8, "sr25519": 4}
# the height whose round-0 proposer each node's validator key is: node 0, the
# address every other node starts from, proposes the height after (c)'s flood
NET_PROPOSES = (3, 2, 4, 5)
NET_FLOOD_AT = 2  # (c), ed25519: this height's precommits wait for the flood's admissions
NET_EQUIVOCATE_AT = {"ed25519": 4, "sr25519": 2}  # (d): its precommits wait for the conflict's report
NET_LUNATIC_AT = {"ed25519": 6, "sr25519": 4}  # (d): its precommits wait for every node's verdict
NET_FAULT_NODE = 3  # (e)
NET_FAULT_ENVELOPES = 256  # (e): a fresh batch, one gossip frame
NET_CONFLICT_VALIDATOR = 7  # (d): the index among the harness's validators of the one that prevotes twice
# generous round timeouts: a height moves on its votes (bypass_commit_timeout once
# all 150 precommits are in), never on a timeout, so every height closes in round 0
NET_TIMEOUTS = {"propose": 5_000_000_000, "propose_delta": 1_000_000_000, "vote": 1_000_000_000,
                "vote_delta": 500_000_000, "commit": 5_000_000_000, "bypass_commit_timeout": True}
NET_STEP_S = 60  # the deadline of each wait of the harness
# how long a wait of the harness trusts the gossip before it reads the nodes'
# WALs each second for what a node signed or stepped to and the gossip lost
NET_GOSSIP_GRACE_S = 10
NET_MESH_S = 30
NET_START_S = 120  # a node process's start-up (imports, its stores, its router)
NET_NODE_SEEDS = tuple(bytes([0x60 + i]) * 32 for i in range(NET_NODES))  # the nodes' p2p keys
NET_HARNESS_SEED = b"\x5a" * 32
# a child's prelude (module, function), run first in each node process; None on the card
NET_CHILD_PRELUDE = None


def network_modules():
    """consensus_modules' and the node's p2p layer: the TCP transport, PEX and
    the consensus, mempool and evidence reactors."""
    from tendermint_tpu_torch import p2p
    from tendermint_tpu_torch.consensus import reactor as cs_reactor
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.evidence import reactor as ev_reactor
    from tendermint_tpu_torch.mempool import reactor as mp_reactor
    from tendermint_tpu_torch.p2p import secret_connection, transport_tcp
    from tendermint_tpu_torch.proto import messages as pb

    return SimpleNamespace(**vars(consensus_modules()), p2p=p2p, cs_reactor=cs_reactor, ev_reactor=ev_reactor,
                           mp_reactor=mp_reactor, tcp=transport_tcp, secret_connection=secret_connection, pb=pb,
                           node_key=ed25519.Ed25519PrivKey)


def net_genesis(m, members, chain_id):
    """cs_genesis with NET_TIMEOUTS."""
    import dataclasses

    gen = cs_genesis(m, members, chain_id)
    gen.consensus_params = dataclasses.replace(gen.consensus_params,
                                               timeout=m.params.TimeoutParams(**NET_TIMEOUTS))
    return gen


def net_channels(m, origin="", metrics=None):
    """A node's channel descriptors: consensus's four, the mempool's, evidence's and PEX's."""
    return (m.cs_reactor.consensus_channel_descriptors(origin, metrics)
            + [m.mp_reactor.mempool_channel_descriptor(), m.ev_reactor.evidence_channel_descriptor(),
               m.p2p.pex_channel_descriptor()])


def net_router(m, key, chain_id, descs):
    """A router on a TcpTransport bound to 127.0.0.1, its listen address in its
    NodeInfo (what PEX advertises); returns (router, transport, peer manager, channels by ID)."""
    nid = m.p2p.node_id_from_pubkey(key.pub_key())
    transport = m.tcp.TcpTransport(descs, bind_host="127.0.0.1")
    ep = transport.endpoint()
    pm = m.p2p.PeerManager(nid, m.p2p.PeerManagerOptions(max_connected=16))
    router = m.p2p.Router(m.p2p.NodeInfo(node_id=nid, network=chain_id, listen_addr=f"{ep.host}:{ep.port}"),
                          key, pm, [transport])
    chans = {d.id: router.open_channel(d) for d in descs}
    return router, transport, pm, chans


@contextlib.contextmanager
def dispatch_records(dev, height):
    """Each batch a node hands its verifier (crypto/ed25519.dispatch_batch,
    both planes' and the pre-verifier's one entry), recorded with the node's
    height, its rows, its distinct keys, its verdict and the launches
    cs_expected gives it from the plane's cache as it stood at the call."""
    import threading

    from tendermint_tpu_torch.crypto import ed25519 as ted

    records, real = [], ted.dispatch_batch
    planes = {}

    def recorded(kind, pks, msgs, sigs, device=None, journey=None):
        P = planes.setdefault(kind, plane(kind))
        keys = [bytes(k) for k in pks]
        present = set(P.cache(dev)._lru)
        rec = SimpleNamespace(height=height(), plane=kind, rows=len(keys), distinct=len(set(keys)), valid=None,
                              present=present, keys=keys, P=P, thread=threading.current_thread().name)
        records.append(rec)
        complete = real(kind, pks, msgs, sigs, device, journey)

        def done():
            ok, bools = complete()
            rec.valid = ok
            return ok, bools
        return done

    ted.dispatch_batch = recorded
    try:
        yield records
    finally:
        ted.dispatch_batch = real


def record_launches(rec, dev):
    """The launches cs_expected gives a dispatch record; none where the
    dispatch gave no verdict (it raised)."""
    if rec.valid is None:
        return {}
    return cs_expected(rec.P, dev, [("rows", rec.keys, rec.valid)], present=rec.present)


@contextlib.contextmanager
def aead_timer(sc):
    """Every seal and open of the secret connections made after entry (their
    AEADs come from secret_connection._aead), timed with their sealed bytes."""
    spent = {"seal_s": 0.0, "open_s": 0.0, "seal_bytes": 0, "open_bytes": 0, "seals": 0, "opens": 0}
    real = sc._aead

    class Timed:
        def __init__(self, key):
            self.inner = real(key)

        def encrypt(self, nonce, data, aad):
            t0 = time.perf_counter()
            out = self.inner.encrypt(nonce, data, aad)
            spent["seal_s"] += time.perf_counter() - t0
            spent["seal_bytes"] += len(out)
            spent["seals"] += 1
            return out

        def decrypt(self, nonce, data, aad):
            t0 = time.perf_counter()
            out = self.inner.decrypt(nonce, data, aad)
            spent["open_s"] += time.perf_counter() - t0
            spent["open_bytes"] += len(data)
            spent["opens"] += 1
            return out

    sc._aead = Timed
    try:
        yield spent
    finally:
        sc._aead = real


@contextlib.contextmanager
def launch_events():
    """card_timer's CUDA events, left readable while the block runs: yields
    the list of (wrapper, start, end) it appends to at each launch. No-op
    without a card."""
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.ops import verify_sr as VS

    events, saved = [], []
    if not torch.cuda.is_available():
        yield events
        return
    for mod in (V, VS, M):
        for fn in kernel_wrappers():
            name = fn.__name__
            real = mod.__dict__.get(name)
            if real is not fn:
                continue

            def timed(*a, _real=real, _name=name, **k):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    return _real(*a, **k)
                finally:
                    end.record()
                    events.append((_name, start, end))

            functools.update_wrapper(timed, real)
            saved.append((mod, name, real))
            setattr(mod, name, timed)
    try:
        yield events
    finally:
        for mod, name, real in saved:
            real.launches = getattr(mod, name).launches
            setattr(mod, name, real)


@contextlib.contextmanager
def card_timer():
    """CUDA events around each kernel wrapper's call, on the calling thread's
    current stream; yields a list that holds each launch's (wrapper, ms) after
    exit. No-op without a card."""
    import torch

    out = []
    with launch_events() as events:
        yield out
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out.extend((name, start.elapsed_time(end)) for name, start, end in events)


class NetNode:
    """One validator node of phase 15, in a process of its own: cs_node's
    layers (a ConsensusState over BlockExecutor(device="cuda"), the kvstore,
    FileDB stores, the evidence pool, a TxMempool with EngineTxPreVerifier, a
    FilePV and a WAL), a router on TCP with a secret connection on every link,
    and the consensus, mempool, evidence and PEX reactors. Commands from the
    parent (cmd_*) arrive over a pipe; what the node saw is instrumented from
    the start: each verifier dispatch, the launch counts at each decided
    height, the consensus thread's busy and CPU time, the AEAD's seals and
    opens, the votes received, the card's time by launch, the handshakes, the
    peer errors reported and the votes it signed."""

    def __init__(self, spec):
        import threading

        import torch

        m = self.m = network_modules()
        self.dev = torch.device("cuda", 0)
        gen = m.genesis.GenesisDoc.from_json(spec["genesis"])
        kind, _, secret = spec["member"]
        where = spec["where"]
        os.makedirs(where, exist_ok=True)
        self.stack = contextlib.ExitStack()
        self.node = node = cs_node(m, gen, file_dbs(m, where), m.privs[kind](secret[1]), where, WallClock(m), self.dev)
        self.decided, self.faults, self.peer_errors, self.own_votes, self.handshakes = [], [], [], [], []
        self.votes_in, self.conflicts = {}, []
        self.lock = threading.Lock()
        self.records = self.stack.enter_context(dispatch_records(self.dev, lambda: node.cs.rs.height))
        self.aead = self.stack.enter_context(aead_timer(m.secret_connection))
        self.card = self.stack.enter_context(card_timer())
        self.spent = self.stack.enter_context(thread_times(cs_parts(m, node)))
        key = m.node_key.generate(spec["node_seed"])
        self.nid = m.p2p.node_id_from_pubkey(key.pub_key())
        descs = net_channels(m, self.nid, node.cs.metrics)
        self.router, self.transport, self.pm, chans = net_router(m, key, gen.chain_id, descs)
        for ch in chans.values():
            real = ch.send_error
            ch.send_error = lambda err, _real=real, _ch=ch.name: (
                self.peer_errors.append(f"{_ch}: {err.node_id[:8]}: {err.err}"), _real(err))
        handshake = m.tcp.TcpConnection.handshake

        def timed_handshake(conn, *a, **k):
            t0 = time.perf_counter()
            out = handshake(conn, *a, **k)
            self.handshakes.append((out[0].node_id, time.perf_counter() - t0))
            return out

        m.tcp.TcpConnection.handshake = timed_handshake
        P = m.p2p.types
        self.cs_reactor = m.cs_reactor.ConsensusReactor(
            node.cs, chans[P.CHANNEL_CONSENSUS_STATE], chans[P.CHANNEL_CONSENSUS_DATA],
            chans[P.CHANNEL_CONSENSUS_VOTE], chans[P.CHANNEL_CONSENSUS_VOTE_SET_BITS], self.pm, node.blocks)
        self.mp_reactor = m.mp_reactor.MempoolReactor(node.mempool, chans[P.CHANNEL_MEMPOOL], self.pm,
                                                      on_fatal=lambda e: self.faults.append(("mempool", e)))
        self.ev_reactor = m.ev_reactor.EvidenceReactor(node.pool, chans[P.CHANNEL_EVIDENCE], self.pm,
                                                       on_fatal=lambda e: self.faults.append(("evidence", e)))
        self.pex = m.p2p.PexReactor(self.pm, chans[P.CHANNEL_PEX])
        broadcast = node.cs.broadcast  # the consensus reactor's hook

        def sent(msg):
            vote = getattr(msg, "vote", None)
            if vote is not None:
                self.own_votes.append((vote.height, vote.round, vote.type, vote.block_id.is_nil()))
            broadcast(msg)

        node.cs.broadcast = sent
        node.cs.on_fatal = lambda e: self.faults.append(("consensus", e))
        node.cs.on_decided = self.on_decided
        add = node.cs.add_peer_message

        def counted(msg, peer_id):
            vote = getattr(msg, "vote", None)
            if vote is not None:
                k = (vote.height, vote.round, vote.type, vote.validator_index)
                with self.lock:
                    self.votes_in[k] = self.votes_in.get(k, 0) + 1
            return add(msg, peer_id)

        node.cs.add_peer_message = counted
        report = node.pool.report_conflicting_votes
        node.pool.report_conflicting_votes = lambda a, b: (self.conflicts.append((a.height, a.validator_index)),
                                                           report(a, b))
        self.router.start()
        for r in (self.pex, self.cs_reactor, self.mp_reactor, self.ev_reactor):
            r.start()

    def on_decided(self, h, block, bid):
        self.decided.append((h, time.monotonic(), {k: v for k, v in read_counts().items() if v}))
        self.node.decided.append((h, time.perf_counter()))

    def address(self):
        ep = self.transport.endpoint()
        return self.nid, f"mconn://{self.nid}@{ep.host}:{ep.port}"

    # -- the parent's commands

    def cmd_status(self):
        cs = self.node.cs
        return {"height": cs.rs.height, "round": cs.rs.round, "mempool": self.node.mempool.size(),
                "peers": sorted(self.pm.peers()), "conflicts": list(self.conflicts),
                "pending": [ev.hash().hex() for ev in self.node.pool.pending_evidence(1 << 20)[0]],
                "faults": [(where, f"{type(e).__name__}: {e}") for where, e in self.faults],
                "peer_errors": list(self.peer_errors), "decided": len(self.decided)}

    def cmd_start(self):
        self.node.cs.start()

    def cmd_dial(self, addr):
        self.pm.add(self.m.p2p.Endpoint.parse(addr))

    def cmd_handshakes(self):
        return list(self.handshakes)

    def cmd_route(self):
        return self.m.secret_connection.route()

    def cmd_submit(self, txs):
        """check_tx_batch of txs at this node: (each outcome's code, the refused ones' logs)."""
        outcomes = self.node.mempool.check_tx_batch(txs)
        return [o.code for o in outcomes], {i: o.log for i, o in enumerate(outcomes) if o.code}

    def cmd_knows(self, tx):
        """Whether this node's mempool or its cache holds tx."""
        key = self.m.mempool.tx_key(tx)
        return self.node.mempool.get_tx(key) is not None or self.node.mempool._cache.has(key)

    def cmd_add_evidence(self, raw):
        ev = self.m.evidence.evidence_from_proto(self.m.pb.Evidence.decode(raw))
        return outcome(lambda: self.node.pool.add_evidence(ev))

    def cmd_pending_evidence(self):
        return [self.m.evidence.evidence_to_proto(ev).encode() for ev in self.node.pool.pending_evidence(1 << 20)[0]]

    def cmd_block(self, h):
        block = self.node.blocks.load_block(h)
        return None if block is None else block.to_proto().encode()

    def cmd_fault(self, message):
        self.stack.enter_context(failing_entries(message))

    def cmd_stop(self):
        """Stop the node and return what it saw."""
        node = self.node
        for r in (self.pex, self.ev_reactor, self.mp_reactor, self.cs_reactor):
            r.stop()
        node.cs.stop()
        self.router.stop()
        self.stack.close()
        heights = node.blocks.height()
        state = node.cs.state
        return {"nid": self.nid, "decided": self.decided,
                "blocks": {h: node.blocks.load_block_meta(h).block_id.hash.hex() for h in range(1, heights + 1)},
                "evidence": {h: [(type(ev).__name__, ev.hash().hex()) for ev in node.blocks.load_block(h).evidence]
                             for h in range(1, heights + 1)},
                "final_counts": {k: v for k, v in read_counts().items() if v},
                "txs": {h: len(node.blocks.load_block(h).txs) for h in range(1, heights + 1)},
                "app_hash": state.app_hash.hex(), "state": self.m.state_store.state_to_json(state),
                "records": [{"height": r.height, "plane": r.plane, "rows": r.rows, "distinct": r.distinct,
                             "valid": r.valid, "thread": r.thread, "launches": record_launches(r, self.dev)}
                            for r in self.records],
                "node_s": self.spent["node"], "node_cpu_s": self.spent["node_cpu"],
                "parts_s": {part: self.spent[part] for part in CS_PARTS},
                "parts_cpu_s": {part: self.spent[part + "_cpu"] for part in CS_PARTS}, "aead": dict(self.aead),
                "card": list(self.card), "votes_in": sum(self.votes_in.values()), "vote_keys": len(self.votes_in),
                "own_votes": self.own_votes, "handshakes": self.handshakes, "peer_errors": self.peer_errors,
                "faults": [(where, f"{type(e).__name__}: {e}") for where, e in self.faults],
                "route": self.m.secret_connection.route()}


def net_node_main(conn, spec):
    """A node process of phase 15: runs NetNode, answering the parent's
    commands (name, args) with ("ok", result) or ("error", traceback) until
    "stop". Exits non-zero on an error outside a command."""
    import traceback

    os.environ["TM_LOG_LEVEL"] = "error"
    try:
        if spec.get("prelude"):
            import importlib

            mod, fn = spec["prelude"]
            getattr(importlib.import_module(mod), fn)()
        node = NetNode(spec)
        conn.send(("ok", node.address()))
        while True:
            cmd, args = conn.recv()
            try:
                conn.send(("ok", getattr(node, "cmd_" + cmd)(*args)))
            except Exception:  # noqa: BLE001 - the parent fails the phase with it
                conn.send(("error", traceback.format_exc()))
            if cmd == "stop":
                return
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            sys.exit(1)


class NetChild:
    """The parent's handle on a node process: call(cmd, *args) -> its result,
    within a deadline; a child that errs, exits or misses it fails the phase."""

    def __init__(self, ctx, index, spec):
        parent, child = ctx.Pipe()
        self.index, self.conn = index, parent
        self.wal = os.path.join(spec["where"], "cs.wal")  # cs_node's; NetHarness reads it
        self.proc = start_process(process=ctx.Process(target=net_node_main, args=(child, spec),
                                                       name=f"net-node-{index}", daemon=True))

    def ready(self):
        self.nid, self.addr = self._reply("start-up", NET_START_S)

    def _reply(self, what, timeout):
        if not self.conn.poll(timeout):
            raise AssertionError(f"phase 15: node {self.index} did not answer {what} within {timeout} s "
                                 f"(exit code {self.proc.exitcode})")
        status, out = self.conn.recv()
        if status != "ok":
            raise AssertionError(f"phase 15: node {self.index} failed in {what}:\n{out}")
        return out

    def call(self, cmd, *args, timeout=NET_STEP_S):
        self.conn.send((cmd, args))
        return self._reply(cmd, timeout)

    def kill(self):
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(10)


class NetHarness:
    """The other validators of phase 15's network (all but the nodes' four),
    played by the parent on a router of its own over TCP, which knows only
    node 0's address and meets the rest by PEX. It speaks the consensus
    channels: when one of its validators proposes, the proposal and its
    parts; for each complete proposal, its prevotes, then its precommits,
    signed by sign(secrets, msgs) -> sigs (phase 14's pool signer). A replica
    (cs_stores over MemDBs) applies each committed block, as the nodes
    validated it, to build the harness's proposals and attacks from.

    A node's router drops a message to a peer whose send queue stays full,
    and the harness announces no round state that would make the nodes
    gossip it again; so a wait that the gossip has not met within
    NET_GOSSIP_GRACE_S reads each node's WAL (child.wal), where the node
    fsyncs its own votes and proposal as it signs them and records its round
    steps, for what is missing (wal_own_records)."""

    def __init__(self, m, gen, members, sign, children, dev, dial=None):
        """dial: the one address the harness starts from (node 0's by default)."""
        import threading

        self.m, self.gen, self.sign, self.children, self.dev = m, gen, sign, children, dev
        self.chain_id = gen.chain_id
        node_addrs = {child.member_addr for child in children}
        self.secrets = {a: s for a, s in member_secrets(m, members).items() if a not in node_addrs}
        self.replica = cs_stores(m, gen, {name: m.kv.MemDB() for name in ("app", "state", "blocks", "evidence")}, dev)
        self.replica.executor.validate_block = lambda state, block: None  # the nodes checked it
        self.builder = m.execution.BlockExecutor(self.replica.states, self.replica.client,
                                                 evidence_pool=self.replica.pool, block_store=self.replica.blocks)
        self.blocks, self.bids, self.spent = {}, {}, {}  # spent: seconds signing and sending votes, by height
        self.steps, self.proposals, self.votes = {}, {}, {}
        # the blocks the harness proposed; when each node was first seen at
        # (height, step); the addresses of halted nodes' validators, whose
        # precommits a LastCommit no longer waits for; the last equivocation
        self.proposed, self.step_times, self.halted, self.equivocation = {}, {}, set(), None
        self.recovered = []  # (what was awaited, [what the nodes' WALs gave])
        self.cond, self.stop = threading.Condition(), threading.Event()
        key = m.node_key.generate(NET_HARNESS_SEED)
        self.nid = m.p2p.node_id_from_pubkey(key.pub_key())
        descs = m.cs_reactor.consensus_channel_descriptors() + [m.p2p.pex_channel_descriptor()]
        self.router, self.transport, self.pm, chans = net_router(m, key, self.chain_id, descs)
        T = m.p2p.types
        self.data, self.vote = chans[T.CHANNEL_CONSENSUS_DATA], chans[T.CHANNEL_CONSENSUS_VOTE]
        self.pex = m.p2p.PexReactor(self.pm, chans[T.CHANNEL_PEX])
        self.threads = [threading.Thread(target=self._recv, args=(ch,), daemon=True, name=f"net-harness-{cid}")
                        for cid, ch in chans.items() if cid != T.CHANNEL_PEX]
        self.router.start()
        self.pex.start()
        for t in self.threads:
            t.start()
        self.pm.add(m.p2p.Endpoint.parse(dial or children[0].addr))

    def close(self):
        self.stop.set()
        self.pex.stop()
        self.router.stop()
        for t in self.threads:
            t.join(10)

    def _recv(self, ch):
        Msgs = self.m.messages
        while not self.stop.is_set():
            env = ch.receive_one(timeout=0.1)
            if env is None:
                continue
            msg = env.message
            with self.cond:
                if isinstance(msg, Msgs.NewRoundStepMessage):
                    self.steps[env.from_] = max(self.steps.get(env.from_, (0, 0, 0)), (msg.height, msg.round, msg.step))
                    self.step_times.setdefault((env.from_, msg.height, msg.step), time.monotonic())
                elif isinstance(msg, Msgs.ProposalMessage):
                    self.proposals[(msg.proposal.height, msg.proposal.round)] = msg.proposal
                elif isinstance(msg, Msgs.VoteMessage):
                    v = msg.vote
                    self.votes.setdefault((v.height, v.round, v.type), {})[v.validator_index] = v
                self.cond.notify_all()

    def wait(self, what, pred, timeout=NET_STEP_S):
        """Wait for pred (under self.cond) until the deadline, reading the
        nodes' WALs each second once NET_GOSSIP_GRACE_S has passed."""
        now = time.monotonic()
        deadline, until = now + timeout, now + min(timeout, NET_GOSSIP_GRACE_S)
        while True:
            with self.cond:
                if self.cond.wait_for(pred, max(0.0, until - time.monotonic())):
                    return
            if time.monotonic() >= deadline:
                raise AssertionError(f"phase 15: {what} within {timeout} s (the nodes at "
                                     f"{sorted(self.steps.values())})")
            got = self._recover()
            if got:
                self.recovered.append((what, got))
                log(f"the harness: waiting for {what}, read from the nodes' WALs what it had not received: "
                    + ", ".join(got))
            until = min(deadline, time.monotonic() + 1.0)

    def _recover(self):
        """Each node's own votes and proposals and its latest round step from
        its WAL, where the harness lacks them; returns what it added."""
        got = []
        for child in self.children:
            path = getattr(child, "wal", None)
            if path is None:
                continue
            votes, proposals, step = wal_own_records(self.m, path)
            with self.cond:
                for v in votes:
                    have = self.votes.setdefault((v.height, v.round, v.type), {})
                    if v.validator_index not in have:
                        have[v.validator_index] = v
                        got.append(f"node {child.index}'s vote ({v.height}, {v.round}, {v.type})")
                for p in proposals:
                    if (p.height, p.round) not in self.proposals:
                        self.proposals[(p.height, p.round)] = p
                        got.append(f"node {child.index}'s proposal ({p.height}, {p.round})")
                if step is not None and step > self.steps.get(child.nid, (0, 0, 0)):
                    self.steps[child.nid] = step
                    self.step_times.setdefault((child.nid, step[0], step[2]), time.monotonic())
                    got.append(f"node {child.index}'s step {step}")
                self.cond.notify_all()
        return got

    def _votes(self, type_, h, block_id, skip=()):
        vals = self.replica.state.validators
        t = self.m.tmtime.Time.now()
        out = [self.m.vote.Vote(type=type_, height=h, round=0, block_id=block_id, timestamp=t,
                                validator_address=v.address, validator_index=i)
               for i, v in enumerate(vals.validators) if v.address in self.secrets and i not in skip]
        for v, sig in zip(out, self.sign([self.secrets[v.validator_address] for v in out],
                                         [v.sign_bytes(self.chain_id) for v in out])):
            v.signature = sig
        return out

    def _last_commit(self, h):
        m = self.m
        if h == self.replica.state.initial_height:
            return m.block.Commit()
        vals = self.replica.states.load_validators(h - 1)
        key = (h - 1, 0, m.vote.PRECOMMIT)
        want = vals.size() - sum(1 for v in vals.validators if v.address in self.halted)
        self.wait(f"all {want} precommits of height {h - 1}", lambda: len(self.votes.get(key, {})) >= want)
        pcs = self.votes[key]
        return m.block.Commit(height=h - 1, round=0, block_id=self.bids[h - 1],
                              signatures=[pcs[i].to_commit_sig() if i in pcs else m.block.CommitSig.new_absent()
                                          for i in range(vals.size())])

    def height(self, h, live, before_precommits=None, equivocate=None, fetch=None, report=False):
        """Drive height h in round 0 among the nodes `live` (children);
        returns when each has committed it, the replica with it. fetch(h)
        gives the committed block's bytes (by default node live[0]'s);
        `report` hands an equivocation's two prevotes to the replica's
        evidence pool too, as a node that saw both does."""
        m, st = self.m, self.replica.state
        PV, PC = m.vote.PREVOTE, m.vote.PRECOMMIT
        proposer = st.validators.get_proposer().address
        if proposer in self.secrets:
            block = self.builder.create_proposal_block(h, st, self._last_commit(h), proposer,
                                                       block_time=m.tmtime.Time.now())
            parts = block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES)
            bid = m.block.BlockID(block.hash(), parts.header)
            prop = m.proposal.Proposal(height=h, round=0, pol_round=-1, block_id=bid, timestamp=block.header.time)
            prop.signature = self.sign([self.secrets[proposer]], [prop.sign_bytes(self.chain_id)])[0]
            self.proposed[h] = block
            for msg in [m.messages.ProposalMessage(prop)] + [
                    m.messages.BlockPartMessage(h, 0, parts.get_part(i)) for i in range(parts.total())]:
                self.data.broadcast(msg, timeout=5)
        else:
            self.wait(f"the proposal of height {h}", lambda: (h, 0) in self.proposals)
            bid = self.proposals[(h, 0)].block_id
        skip = ()
        t0 = time.perf_counter()
        prevotes = self._votes(PV, h, bid)
        if equivocate is not None:
            val_index, to_a, to_b = equivocate
            (honest,) = [v for v in prevotes if v.validator_index == val_index]
            (other,) = self._votes(PV, h, m.block.BlockID(), skip=[i for i in range(st.validators.size())
                                                                    if i != val_index])
            self.vote.send_to(to_a, m.messages.VoteMessage(honest), timeout=5)
            self.vote.send_to(to_b, m.messages.VoteMessage(other), timeout=5)
            skip = (val_index,)
            self.equivocation = (honest, other)
        for v in prevotes:
            if v.validator_index not in skip:
                self.vote.broadcast(m.messages.VoteMessage(v), timeout=5)
        self.spent[h] = time.perf_counter() - t0
        if before_precommits is not None:
            # every node has checked the proposal (a hook's checks must not
            # share an engine group with a LastCommit check)
            idx = [st.validators.get_by_address(c.member_addr)[0] for c in live]
            self.wait(f"the nodes' prevotes of height {h}",
                      lambda: all(i in self.votes.get((h, 0, PV), {}) for i in idx))
            before_precommits()
        t0 = time.perf_counter()
        precommits = self._votes(PC, h, bid)
        with self.cond:
            self.votes.setdefault((h, 0, PC), {}).update({v.validator_index: v for v in precommits})
        for v in precommits:
            self.vote.broadcast(m.messages.VoteMessage(v), timeout=5)
        self.spent[h] += time.perf_counter() - t0
        nids = [c.nid for c in live]
        self.wait(f"every node's commit of height {h}", lambda: all(self.steps.get(n, (0,))[0] > h for n in nids))
        raw = fetch(h) if fetch is not None else live[0].call("block", h)
        block = m.block.Block.from_proto(m.pb.Block.decode(raw))
        if block.hash() != bid.hash:
            raise AssertionError(f"phase 15: height {h} committed {block.hash().hex()}, proposed {bid.hash.hex()}")
        self.blocks[h], self.bids[h] = block, bid
        with self.cond:
            pcs = dict(self.votes[(h, 0, PC)])
        seen = m.block.Commit(height=h, round=0, block_id=bid, signatures=[
            pcs[i].to_commit_sig() if i in pcs else m.block.CommitSig.new_absent()
            for i in range(st.validators.size())])
        self.replica.blocks.save_block(block, block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES), seen)
        if report and equivocate is not None:
            self.replica.pool.report_conflicting_votes(*self.equivocation)
        with env_setting("TM_TPU_CRYPTO", "off"):
            self.replica.state = self.replica.executor.apply_block(self.replica.state, bid, block)
        return block

    def lunatic(self, c, tag):
        """LightClientAttackEvidence against committed height c: its header
        with a forged app hash, signed by this harness's validators (the
        nodes' slots absent), its common height c itself, so that a node's
        check is the conflicting commit's 2/3 light check."""
        import dataclasses

        m = self.m
        header = self.blocks[c].header
        vals = self.replica.states.load_validators(c)
        forged = dataclasses.replace(header, app_hash=tagged(tag, c))
        bid = m.block.BlockID(forged.hash(), m.block.PartSetHeader(1, tagged(tag + b" parts", c)))
        commit = m.block.Commit(height=c, round=0, block_id=bid, signatures=[
            m.block.CommitSig.new_commit(v.address, header.time, b"") if v.address in self.secrets
            else m.block.CommitSig.new_absent() for v in vals.validators])
        signers = [i for i, v in enumerate(vals.validators) if v.address in self.secrets]
        sigs = self.sign([self.secrets[vals.validators[i].address] for i in signers],
                         [commit.vote_sign_bytes(self.chain_id, i) for i in signers])
        for i, sig in zip(signers, sigs):
            commit.signatures[i].signature = sig
        ev = m.evidence.LightClientAttackEvidence(
            conflicting_block=m.light_block.LightBlock(m.light_block.SignedHeader(forged, commit), vals),
            common_height=c)
        trusted = m.light_block.SignedHeader(header, self.blocks[c + 1].last_commit if c + 1 in self.blocks
                                             else m.block.Commit(height=c, round=0, block_id=self.bids[c],
                                                                 signatures=[self.votes[(c, 0, m.vote.PRECOMMIT)][i]
                                                                             .to_commit_sig()
                                                                             for i in range(vals.size())]))
        ev.generate_abci(vals, trusted, header.time)
        return ev

    def add_evidence(self, ev):
        """The evidence into the replica's pool too (for the harness's next
        proposal), checked on the host."""
        with env_setting("TM_TPU_CRYPTO", "off"):
            self.replica.pool.add_evidence(ev)


def wal_own_records(m, path):
    """From the WAL at path (its rotated files, then its head; a torn last
    record left out): the node's own votes, its own proposals, and its latest
    round step as (height, round, step) or None."""
    import glob

    own, step = (b'{"type":"msg_info","peer_id":"",', b'{"type":"round_step",')
    votes, proposals, latest = [], [], None
    for p in sorted(glob.glob(path + "." + "[0-9]" * 9)) + [path]:
        try:
            with open(p, "rb") as f:
                data = f.read()
        except FileNotFoundError:  # rotated while read: the next reading has it
            continue
        for _, payload in m.wal.iter_wal_records(data):
            if not payload.startswith((own, step)):
                continue
            rec = m.wal._decode_msg(json.loads(payload))
            if isinstance(rec, m.wal.EventRoundStep):
                latest = max(latest or (0, 0, 0), (rec.height, rec.round, rec.step))
            elif isinstance(rec.msg, m.messages.VoteMessage):
                votes.append(rec.msg.vote)
            elif isinstance(rec.msg, m.messages.ProposalMessage):
                proposals.append(rec.msg.proposal)
    return votes, proposals, latest


def net_light_rows(vals, absent):
    """The rows of a 2/3 light check of a commit of vals with `absent`'s
    addresses absent: the signatures it tallies before passing 2/3."""
    needed = vals.total_voting_power() * 2 // 3
    tallied = rows = 0
    for v in vals.validators:
        if v.address in absent:
            continue
        rows += 1
        tallied += v.voting_power
        if tallied > needed:
            return rows
    return rows


def net_statuses(children, what, pred, timeout=NET_STEP_S):
    """Poll the children's statuses until pred(statuses) holds; returns them."""
    deadline = time.monotonic() + timeout
    while True:
        statuses = [c.call("status") for c in children]
        if pred(statuses):
            return statuses
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 15: {what} within {timeout} s: " + json.dumps(statuses)[:2000])
        time.sleep(0.05)


def network_phase(planes, chain_id, built, runs, tmp, sign):
    """Phase 15 on each plane: four node processes and the harness meet by
    PEX over TCP with secret connections, then drive NET_HEIGHTS heights
    with (c)'s flood, (d)'s equivocation and lunatic attack, and (e)'s
    faults; every node's launches held per height; (f) the timings. The
    harness signs with `sign`, on the pool phases 14-16 share."""
    m = network_modules()
    totals = {}
    for kind, P in planes.items():
        _network_plane(m, kind, P, chain_id, built, sign, runs, totals, os.path.join(tmp, kind))
    check_path("phase 15", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()]
               + [{plane("ed25519").rlc.__name__: 1}])  # the envelopes' plane, whatever the validators'
    return totals


def _network_plane(m, kind, P, chain_id, built, sign, runs, totals, where):
    import multiprocessing

    import torch

    dev = torch.device("cuda", 0)
    ctx = multiprocessing.get_context("spawn")
    members = built[kind].members
    gen = net_genesis(m, members, f"{chain_id}-net-{kind}")
    heights = NET_HEIGHTS[kind]
    flood = kind == "ed25519"
    E, L = NET_EQUIVOCATE_AT[kind], NET_LUNATIC_AT[kind]
    sched = proposer_schedule(m, gen, max(NET_PROPOSES))
    index_of = {m.keys[k](pub).address(): i for i, (k, pub, _) in enumerate(members)}
    node_members = [members[index_of[sched[h - 1]]] for h in NET_PROPOSES]
    node_addrs = {m.keys[k](pub).address() for k, pub, _ in node_members}
    ed = plane("ed25519")
    children, harness = [], None
    t_start = time.perf_counter()
    try:
        specs = [{"kind": kind, "genesis": gen.to_json(), "member": member, "where": os.path.join(where, f"node{i}"),
                  "node_seed": NET_NODE_SEEDS[i], "prelude": NET_CHILD_PRELUDE}
                 for i, member in enumerate(node_members)]
        children = [NetChild(ctx, i, spec) for i, spec in enumerate(specs)]
        for c in children:
            c.ready()
        for c, member in zip(children, node_members):
            c.member_addr = m.keys[member[0]](member[1]).address()
        log(f"phase 15: {kind} four node processes up in {time.perf_counter() - t_start:.1f} s")
        # (a) every node and the harness start from node 0's address alone
        t0 = time.perf_counter()
        for c in children[1:]:
            c.call("dial", children[0].addr)
        harness = NetHarness(m, gen, members, sign, children, dev)
        net_statuses(children, "the mesh",
                                lambda s: all(len(st["peers"]) == NET_NODES for st in s)
                                and len(harness.pm.peers()) == NET_NODES, NET_MESH_S)
        mesh_s = time.perf_counter() - t0
        shakes = [c.call("handshakes") for c in children]
        log(f"phase 15: {kind} (a) the mesh of {NET_NODES} nodes and the harness by PEX over TCP in "
            f"{mesh_s * 1e3:.1f} ms; secret-connection handshakes, ms: "
            + json.dumps({f"node {c.index}": sorted(round(s * 1e3, 2) for _, s in sh)
                          for c, sh in zip(children, shakes)})
            + f"; the AEAD route {children[0].call('route')}, the harness's {m.secret_connection.route()}")
        for c in children:
            c.call("start")
        # (b)-(d)
        seen = {}

        def flood_hook():
            batches = built["ed25519"].batches
            label, txs, _ = admission_batch("valid", batches["valid"])
            codes, refused = children[0].call("submit", txs)
            if any(codes):
                raise AssertionError(f"phase 15: (c) node 0 refused {refused}")
            net_statuses(children, "(c) the flood's admission at every node",
                         lambda s: all(st["mempool"] == len(txs) for st in s))
            label, bad, _ = admission_batch("tampered", batches["tampered"])
            codes, refused = children[0].call("submit", bad)
            want = {CS_TAMPER_ENVELOPE: "tx signature pre-verification failed"}
            if refused != want:
                raise AssertionError(f"phase 15: (c) the tampered batch: node 0 refused {refused}, expected {want}")
            net_statuses(children, "(c) the second batch's admission at every node",
                         lambda s: all(st["mempool"] == 2 * len(txs) - 1 for st in s))
            if any(c.call("knows", bad[CS_TAMPER_ENVELOPE]) for c in children[1:]):
                raise AssertionError(f"phase 15: (c) envelope #{CS_TAMPER_ENVELOPE} was gossiped")
            seen["flood"] = len(txs)

        # (d): the node proposing E + 1 gets the nil prevote; the maj23 gossip
        # brings it the other, and it reports the pair (the set is genesis's until then)
        detector = children[NET_PROPOSES.index(E + 1)]
        other = children[(detector.index + 2) % NET_NODES]
        seen["equivocator"] = [i for i, v in enumerate(m.state.make_genesis_state(gen).validators.validators)
                               if v.address not in node_addrs][NET_CONFLICT_VALIDATOR]

        def equivocation_hook():
            net_statuses([detector], f"(d) node {detector.index}'s report of the conflicting prevotes",
                         lambda s: [E, seen["equivocator"]] in [list(x) for x in s[0]["conflicts"]])

        def lunatic_hook():
            ev = harness.lunatic(L - 1, b"lunatic")
            seen["lunatic"] = ev
            seen["lunatic_rows"] = net_light_rows(harness.replica.states.load_validators(L - 1), node_addrs)
            got = children[0].call("add_evidence", m.evidence.evidence_to_proto(ev).encode())
            if tuple(got) != ("accepted", ""):
                raise AssertionError(f"phase 15: (d) node 0 refused the lunatic attack: {got}")
            harness.add_evidence(ev)
            net_statuses(children, "(d) the lunatic attack in every node's pool",
                         lambda s: all(ev.hash().hex() in st["pending"] for st in s))

        def fault_hook():
            """(e), before the last height's precommits: node NET_FAULT_NODE's
            device entry points fail; a fresh batch admitted at node 0 and
            gossiped, then a second attack added at node 0 and gossiped, each
            awaited (two checks at once would share an engine group)."""
            if L == heights:
                lunatic_hook()
            message = seen["fault_message"] = f"no kernel for device {dev}"
            fault = f"ValueError: {message}"
            seen["errors_before"] = [c.call("status")["peer_errors"] for c in children]
            children[NET_FAULT_NODE].call("fault", message)
            faults = lambda s: {tuple(f) for f in s[NET_FAULT_NODE]["faults"]}
            others = lambda s: [st for i, st in enumerate(s) if i != NET_FAULT_NODE]
            txs = [tx for _, tx in built["ed25519"].batches["fault"]]
            codes, refused = children[0].call("submit", txs)
            if any(codes):
                raise AssertionError(f"phase 15: (e) node 0 refused {refused}")
            net_statuses(children, "(e) the gossiped admission: the others' and the faulty node's fault",
                         lambda s: ("mempool", fault) in faults(s)
                         and all(st["mempool"] >= len(txs) for st in others(s)))
            ev = harness.lunatic(heights - 1, b"lunatic (e)")
            got = children[0].call("add_evidence", m.evidence.evidence_to_proto(ev).encode())
            if tuple(got) != ("accepted", ""):
                raise AssertionError(f"phase 15: (e) node 0 refused the second attack: {got}")
            harness.add_evidence(ev)
            net_statuses(children, "(e) the gossiped attack: the others' checks and the faulty node's fault",
                         lambda s: ("evidence", fault) in faults(s)
                         and all(ev.hash().hex() in st["pending"] for st in others(s)))

        for h in range(1, heights + 1):
            hook = {NET_FLOOD_AT: flood_hook if flood else None, E: equivocation_hook, L: lunatic_hook,
                    heights: fault_hook}.get(h)
            equivocate = (seen["equivocator"], other.nid, detector.nid) if h == E else None
            harness.height(h, children, before_precommits=hook, equivocate=equivocate)
        harness.height(heights + 1, [c for i, c in enumerate(children) if i != NET_FAULT_NODE])
        peers = [c.call("status")["peers"] for c in children]  # before any node stops
        reports = [dict(c.call("stop"), peers=p) for c, p in zip(children, peers)]
    finally:
        if harness is not None:
            harness.close()
        for c in children:
            c.kill()
    _network_checks(m, kind, P, ed, reports, harness, heights, E, L, flood, seen, len(members), totals)
    _network_timings(kind, reports, harness, heights, E, L, flood, mesh_s, len(members), runs)


def net_expected(P, ed, heights, E, L, flood, node):
    """The launches phase 15 predicts for a node, by height: none at height
    1; at 2 the first LastCommit check, a split fill and a split hit; one hit
    at each later height; (c), ed25519, at NET_FLOOD_AT: node 0 the valid
    batch's RLC and the tampered one's RLC, fill and hit, the others the two
    gossiped batches in RLCs whose count is given as a range (batching
    follows frame arrival), and where the second batch's last frame (255
    envelopes) is admitted alone, its fill and hit; (d) at L the lunatic check, one hit; (e) at the
    last height, but on the faulty node: the second attack, one hit, and node
    0 the fresh batch's RLC, the others it gossiped, 1-2 RLCs; at the height
    after it the faulty node nothing. Values are ints or (low, high)
    ranges."""
    out = {}
    for h in range(1, heights + 2):
        want = {} if h == 1 else ({P.fill.__name__: 1, P.hit.__name__: 1} if h == 2 else {P.hit.__name__: 1})
        if flood and h == NET_FLOOD_AT:
            if node == 0:
                want = merge_counts(want, {ed.rlc.__name__: 2, ed.fill.__name__: 1, ed.hit.__name__: 1})
            else:
                # the second batch's 1,023 envelopes come in frames of 256, 256,
                # 256 and 255: a batch of the last frame alone is under the
                # RLC's cutover, so the bitmap plane takes it (a fill of the
                # account keys, then a hit)
                want = merge_counts(want, {ed.rlc.__name__: (2, 8), ed.fill.__name__: (0, 1),
                                           ed.hit.__name__: (0, 1)})
        if h == L:
            want = merge_counts(want, {P.hit.__name__: 1})
        if h == heights and node != NET_FAULT_NODE:
            want = merge_counts(want, {P.hit.__name__: 1, ed.rlc.__name__: 1 if node == 0 else (1, 2)})
        if h == heights + 1 and node == NET_FAULT_NODE:
            want = {}
        out[h] = want
    return out


def merge_counts(a, b):
    out = dict(a)
    for k, v in b.items():
        if k in out:
            lo, hi = (out[k], out[k]) if isinstance(out[k], int) else out[k]
            vlo, vhi = (v, v) if isinstance(v, int) else v
            out[k] = lo + vlo if (lo, hi) == (lo, lo) and vlo == vhi else (lo + vlo, hi + vhi)
        else:
            out[k] = v
    return out


def counts_match(got, want):
    if set(got) != set(want):
        return False
    return all(got[k] == v if isinstance(v, int) else v[0] <= got[k] <= v[1] for k, v in want.items())


def _network_checks(m, kind, P, ed, reports, harness, heights, E, L, flood, seen, n_vals, totals):
    """Every node committed the same blocks and state; each node's launches,
    height by height, equal both the model of its dispatches and the
    prediction; (c)'s rows; (d)'s evidence committed; (e)'s faults."""
    for i, r in enumerate(reports):
        top = heights if i == NET_FAULT_NODE else heights + 1
        blocks = {int(h): b for h, b in r["blocks"].items()}
        if sorted(blocks) != list(range(1, top + 1)) or any(b != harness.bids[h].hash.hex() for h, b in blocks.items()):
            raise AssertionError(f"phase 15: {kind} node {i} committed {blocks}")
        if i != NET_FAULT_NODE and (r["app_hash"] != harness.replica.state.app_hash.hex()
                                    or r["state"] != m.state_store.state_to_json(harness.replica.state)):
            raise AssertionError(f"phase 15: {kind} node {i}'s app hash or state differs from the replica's")
    log(f"phase 15: {kind} (b) every node committed the same {heights} blocks, the live ones {heights + 1}; app "
        f"hash {reports[0]['app_hash']} and state equal to the harness's replica")
    by = lambda r, h, thread: [x for x in r["records"] if x["height"] == h and x["thread"] == thread]
    for i, r in enumerate(reports):
        want = net_expected(P, ed, heights, E, L, flood, i)
        counts = {h: c for h, _, c in r["decided"]}
        top = max(counts)
        if i == NET_FAULT_NODE:
            counts[top + 1] = r["final_counts"]
            top += 1
        elif r["final_counts"] != counts[top]:
            raise AssertionError(f"phase 15: {kind} node {i} launched after its last height: {r['final_counts']}")
        prev, lines = {}, {}
        for h in range(1, top + 1):
            delta = {k: v - prev.get(k, 0) for k, v in counts[h].items() if v - prev.get(k, 0)}
            prev = counts[h]
            model = {}
            for rec in r["records"]:
                if rec["height"] == h:
                    model = merge_counts(model, rec["launches"])
                    lines.setdefault(h, []).append([rec["thread"], rec["rows"], rec["distinct"], rec["launches"]])
            if delta != model or not counts_match(delta, want[h]):
                raise AssertionError(f"phase 15: {kind} node {i} height {h} launched {delta}, its dispatches "
                                     f"{model}, predicted {want[h]}; {lines.get(h)}")
            for k, v in delta.items():
                totals[k] = totals.get(k, 0) + v
        checks = [x["rows"] for h in range(2, top + 1) for x in by(r, h, "consensus")]
        if not all(n_vals - NET_NODES <= n <= n_vals for n in checks):
            raise AssertionError(f"phase 15: {kind} node {i}'s LastCommit checks carried {checks} rows")
        log(f"phase 15: {kind} node {i} launches by height, each dispatch [thread, rows, distinct keys, launches]: "
            + json.dumps(lines))
        # (c): the gossiped batches, every envelope once on the card; (d) the attack's light check
        if flood:
            gossiped = by(r, NET_FLOOD_AT, "_recv_loop")
            if i and sum(x["distinct"] for x in gossiped) != 2 * seen["flood"] - 1:
                raise AssertionError(f"phase 15: {kind} (c) node {i} admitted {gossiped}")
        attack = by(r, L, "MainThread" if i == 0 else "evidence-recv")[:1]
        if [x["rows"] for x in attack] != [seen["lunatic_rows"]]:
            raise AssertionError(f"phase 15: {kind} (d) node {i} checked the lunatic attack on {attack}")
    if flood:
        log(f"phase 15: {kind} (c) node 0 admitted {seen['flood']} envelopes (one RLC) and refused "
            f"#{CS_TAMPER_ENVELOPE} of the second batch (RLC, fill, hit); the others admitted both batches "
            f"from the gossip, each envelope once on the card; #{CS_TAMPER_ENVELOPE} reached none")
    # (d): the duplicate vote committed in a block after E on every node; the attack checked on the card
    for i, r in enumerate(reports):
        dup = [h for h, evs in r["evidence"].items() if int(h) > E and any(t == "DuplicateVoteEvidence" for t, _ in evs)]
        if not dup:
            raise AssertionError(f"phase 15: {kind} (d) node {i} committed no duplicate-vote evidence after {E}")
    log(f"phase 15: {kind} (d) validator {seen['equivocator']}'s two prevotes at {E}, sent to two nodes, became "
        f"DuplicateVoteEvidence, gossiped and committed at height {dup[0]} (checked on the host); the lunatic "
        f"attack at {L - 1} was checked on the card by every node, one hit of {seen['lunatic_rows']} rows")
    # (e)
    faulty = reports[NET_FAULT_NODE]
    fault = f"ValueError: {seen['fault_message']}"
    kinds = {tuple(f) for f in faulty["faults"]}
    if not {("mempool", fault), ("evidence", fault), ("consensus", fault)} <= kinds:
        raise AssertionError(f"phase 15: {kind} (e) the faulty node's on_fatal got {faulty['faults']}")
    own = [v for v in faulty["own_votes"] if v[0] > heights]
    # the peers the reactors reported while the faults ran (PEX's throttle may
    # report a peer at any time under load: counted, not a fault's)
    added = [e for r, before in zip(reports, seen["errors_before"]) for e in r["peer_errors"][len(before):]
             if e.startswith(("mempool", "evidence"))]
    if own or added:
        raise AssertionError(f"phase 15: {kind} (e) the faulty node signed {own}; peers reported {added}")
    reported = {}
    for r in reports:
        for e in r["peer_errors"]:
            reported[e.split(":")[0]] = reported.get(e.split(":")[0], 0) + 1
    log(f"phase 15: {kind} (e) with node {NET_FAULT_NODE}'s device entry points failing, the gossiped admission's "
        f"and the gossiped attack's faults reached its on_fatal through the mempool and evidence reactors, "
        f"then its consensus's at height {heights + 1}; the mempool and evidence reactors reported no peer, and "
        f"it signed no prevote; its peers at the end {len(faulty['peers'])}, the others' "
        f"{[len(r['peers']) for r in reports if r is not faulty]}; peers reported over the run, by channel: "
        f"{json.dumps(reported)}")


def card_floor(launches):
    """The card's time of launches [(kernel, ms)] taken at each kernel's
    fastest launch of the run: what the events' brackets say less the host
    work some of them enclose (the wrapper's own steps, a wait for the GIL)."""
    fastest = {}
    for name, ms in launches:
        fastest[name] = min(ms, fastest.get(name, ms))
    return sum(fastest[name] for name, _ in launches)


def _network_timings(kind, reports, harness, heights, E, L, flood, mesh_s, n_vals, runs):
    """(f): heights/s of the network (every node's commit) over the heights
    with no pause of the harness's, and over 2..heights; each node's busy and
    CPU ms, AEAD, votes and card time a height."""
    t = {h: max(tm for r in reports for hh, tm, _ in r["decided"] if hh == h) for h in range(1, heights + 1)}
    paused = {E, L} | ({NET_FLOOD_AT} if flood else set())
    spans = {h: t[h] - t[h - 1] for h in range(2, heights + 1)}
    clean = [h for h in spans if h not in paused]
    hps = len(clean) / sum(spans[h] for h in clean) if clean else float("nan")
    hps_all = (heights - 1) / (t[heights] - t[1])
    per = []
    for i, r in enumerate(reports):
        n = len(r["decided"])
        a = r["aead"]
        per.append({"node": i, "busy_ms": r["node_s"] * 1e3 / n, "cpu_ms": r["node_cpu_s"] * 1e3 / n,
                    "seal_ms": a["seal_s"] * 1e3 / n, "open_ms": a["open_s"] * 1e3 / n,
                    "wire_bytes": (a["seal_bytes"] + a["open_bytes"]) / n, "votes_in": r["votes_in"] / n,
                    "duplicate_votes": (r["votes_in"] - r["vote_keys"]) / n,
                    "card_ms": sum(ms for _, ms in r["card"]) / n, "card_floor_ms": card_floor(r["card"]) / n,
                    "parts": {k: [round(v * 1e3 / n, 2), round(r["parts_cpu_s"][k] * 1e3 / n, 2)]
                              for k, v in r["parts_s"].items()}, "heights": n})
    log(f"phase 15: {kind} (f) {hps:.3f} heights/s over heights {clean} (the harness paused none of them), "
        f"{hps_all:.3f} over 2-{heights}; ms a height, 2-{heights}: "
        + json.dumps({h: round(s * 1e3, 2) for h, s in spans.items()})
        + "; the harness's signing and sending of its votes, ms: "
        + json.dumps({h: round(harness.spent[h] * 1e3, 2) for h in spans}) + f" on {card()}")
    for p in per:
        log(f"phase 15: {kind} (f) node {p['node']} a height: busy {p['busy_ms']:.2f} ms, CPU {p['cpu_ms']:.2f} ms; "
            f"AEAD seal {p['seal_ms']:.3f} ms, open {p['open_ms']:.3f} ms, {p['wire_bytes']:.0f} bytes on the wire; "
            f"{p['votes_in']:.1f} votes received, {p['duplicate_votes']:.1f} duplicates; the card {p['card_ms']:.3f} ms "
            f"between each launch's events, {p['card_floor_ms']:.3f} ms at each kernel's fastest ({p['heights']} "
            f"heights); the consensus thread's ms by part [wall, CPU]: {json.dumps(p['parts'])} on {card()}")
    runs.append({"plane": kind, "run": "network (f)", "commit": n_vals, "s": t[heights] - t[1],
                 "heights_per_s": hps, "mesh_s": mesh_s,
                 "node_s": sum(p["busy_ms"] for p in per) / len(per) / 1e3})


# -- phase 16: the node as its operators run it ---------------------------------

CLI_NODES = 4
CLI_HEIGHTS = {"ed25519": 8, "sr25519": 3}  # heights every node commits; the fault's height and one more follow
CLI_EQUIVOCATE_AT = {"ed25519": 4, "sr25519": 2}
CLI_LUNATIC_AT = {"ed25519": 6, "sr25519": 3}  # (d): its precommits wait for every node's check of the attack
CLI_FLOOD_AT = 3  # (c), ed25519: its precommits wait for both batches' admissions at every node
CLI_COMMIT_AT = 4  # (c), ed25519: broadcast_tx_commit's envelope, admitted here, committed the height after
CLI_FAULT_NODE = 3  # (e): started through cli_launcher
CLI_START_S = 120  # a node process's start-up: imports, its stores, its router, its RPC
CLI_SYNC_S = 120  # (f): the full node's blocksync
CLI_RPC_S = 30  # a client's timeout
CLI_PAGE = 100  # the RPC's largest page
LABELS = ("pk_table_build", "bitmap_cached", "rlc")  # kernel_launches_total's labels on this path
# phase 15's timeouts, but a propose timeout that outlasts the harness's work
# between heights (the RPC's checks, a 2,047-tx block to build): a node that
# waits for the proposal must never prevote nil in round 0
CLI_TIMEOUTS = {**NET_TIMEOUTS, "propose": 30_000_000_000}


def cli_modules():
    """network_modules' and the port's RPC client."""
    from tendermint_tpu_torch import privval
    from tendermint_tpu_torch.rpc import client as rpc_client

    return SimpleNamespace(**vars(network_modules()), rpc_client=rpc_client, privval=privval)


def cli_command(args, home=None, timeout=300):
    """`python -m tendermint_tpu_torch [--home home] args` to its end; its stdout."""
    argv = [sys.executable, "-m", "tendermint_tpu_torch"] + (["--home", home] if home else []) + list(args)
    return run_process(argv, timeout, "phase 16", cwd=ROOT, env=cli_env()).stdout


def cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def cli_launcher(home, trigger, dump, message):
    """Phase 16's faulty node, in a process of its own: `start` through the
    port's CLI (cli.main), with a thread that, once the file `trigger`
    exists, makes every device entry point of both planes raise the kernel
    wrapper's ValueError(message) and sends every batch to the card (both
    cutovers at 1, so one envelope reaches the failing entry point); and
    that writes to `dump`, every 0.2 s, the kernel wrappers' launch counts,
    each launch's card ms (CUDA events around the wrapper), the consensus
    thread's busy and CPU seconds, and whether the fault is installed."""
    import threading

    import torch

    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.crypto import ed25519 as ted

    stack = contextlib.ExitStack()
    spent = stack.enter_context(thread_times([(ConsensusState, "_dispatch", "node")]))
    events = stack.enter_context(launch_events())
    state = {"fault": False}

    def watch():
        while True:
            if not state["fault"] and os.path.exists(trigger):
                ted.DEVICE_BATCH_CUTOVER = ted.MSM_BATCH_CUTOVER = 1
                stack.enter_context(failing_entries(message))
                state["fault"] = True
            card = [(name, start.elapsed_time(end)) for name, start, end in list(events) if end.query()]
            tmp = dump + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"counts": read_counts(), "card": card, "busy_s": spent["node"],
                           "cpu_s": spent["node_cpu"], "fault": state["fault"]}, f)
            os.replace(tmp, dump)
            time.sleep(0.2)

    if torch.cuda.is_available():
        torch.cuda.init()
    threading.Thread(target=watch, daemon=True, name="launcher-watch").start()
    return cli.main(["--home", home, "start"])


def scrape(url):
    """A Prometheus text exposition as {(name, ((label, value), ...)): value}."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=CLI_RPC_S) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        pairs = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labels)))
        out[(name, pairs)] = float(value)
    return out


def metric(sample, name, **labels):
    """The sum of a family's samples whose labels include `labels`."""
    want = set(labels.items())
    return sum(v for (n, pairs), v in sample.items() if n == name and want <= set(pairs))


def launches_of(sample):
    return {k: int(metric(sample, "tendermint_engine_kernel_launches_total", kernel=k)) for k in LABELS}


def engine_rows(sample, plane_name):
    """Rows and launches by the engine's path on a plane, and rejected rows."""
    paths = {dict(p).get("path") for (n, p) in sample if n == "tendermint_engine_path_rows_total"}
    rows = {path: int(metric(sample, "tendermint_engine_path_rows_total", plane=plane_name, path=path))
            for path in paths if path}
    launches = {path: int(metric(sample, "tendermint_engine_launches_total", plane=plane_name, path=path))
                for path in paths if path}
    rejected = int(metric(sample, "tendermint_engine_path_rows_total", plane=plane_name, status="reject"))
    return {"rows": rows, "launches": launches, "rejected": rejected}


def delta(after, before):
    if isinstance(after, dict):
        out = {k: delta(v, before.get(k, 0 if not isinstance(v, dict) else {})) for k, v in after.items()}
        return {k: v for k, v in out.items() if v}
    return after - before


def proc_cpu_s(pid):
    """A process's user and system CPU seconds, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class CliNode:
    """A node process started through the CLI (`python -m
    tendermint_tpu_torch --home H start`, or cli_launcher's): its stdout's
    addresses, its log, an RPC client, its /metrics and its WebSocket's
    NewBlock arrivals. A process that exits early or misses a deadline
    fails the phase."""

    def __init__(self, index, home, argv, log_path):
        import queue
        import threading

        self.index, self.home, self.log_path = index, home, log_path
        self.t_spawn = time.monotonic()
        self.log_file = open(log_path, "w")
        self.proc = start_process(argv, cwd=ROOT, env=cli_env(), stdout=subprocess.PIPE, stderr=self.log_file,
                                  text=True, start_new_session=True)
        self.lines = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(line) for line in self.proc.stdout], daemon=True,
                         name=f"cli-node-{index}-stdout").start()
        self.rpc = self.metrics_url = self.ws = None
        self.new_blocks = {}  # height -> arrival (monotonic) of its NewBlock event
        self.rpc_ms = {}  # route -> [ms]

    def ready(self, what, timeout=CLI_START_S):
        """Wait for the start-up lines; returns {name: value} of `name: value` lines."""
        import queue

        got, deadline = {}, time.monotonic() + timeout
        while "p2p" not in got or (what == "node" and "prometheus" not in got):
            try:
                line = self.lines.get(timeout=max(0.0, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                line = None
            if line is not None:
                key, sep, value = line.strip().partition(": ")
                if sep:
                    got[key] = value
            elif self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"phase 16: {what} {self.index} did not start within {timeout} s (exit code "
                                     f"{self.proc.poll()}):\n{self.log_tail()}")
        self.addresses = got
        if what == "node":
            host_port = got["rpc"].split("//", 1)[1]
            self.rpc_url = got["rpc"]
            self.host, self.port = host_port.rsplit(":", 1)[0], int(host_port.rsplit(":", 1)[1])
            self.metrics_url = got["prometheus"]
        return got

    def client(self, m):
        self.rpc = m.rpc_client.HTTPClient(self.rpc_url, timeout=CLI_RPC_S)
        self.t_first_rpc = None
        deadline = time.monotonic() + CLI_START_S
        while self.t_first_rpc is None:
            try:
                self.rpc.call("health")
                self.t_first_rpc = time.monotonic()
            except (OSError, m.rpc_client.RPCClientError):
                if time.monotonic() > deadline or self.proc.poll() is not None:
                    raise
                time.sleep(0.05)

    def call(self, method, **params):
        t0 = time.perf_counter()
        out = self.rpc.call(method, **params)
        self.rpc_ms.setdefault(method, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def batch(self, requests):
        """One JSON-RPC batch POST of [(method, params)]; the results in order."""
        import http.client

        body = json.dumps([{"jsonrpc": "2.0", "id": i, "method": meth, "params": params}
                           for i, (meth, params) in enumerate(requests)])
        conn = http.client.HTTPConnection(self.host, self.port, timeout=CLI_RPC_S)
        try:
            conn.request("POST", "/", body=body, headers={"Content-Type": "application/json"})
            out = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        out = sorted(out, key=lambda r: r["id"])
        errors = [r["error"] for r in out if "error" in r]
        if errors:
            raise AssertionError(f"phase 16: node {self.index}'s batch of {len(requests)} answered {errors[:3]}")
        return [r["result"] for r in out]

    def scrape(self):
        if self.proc.poll() is not None:
            raise AssertionError(f"phase 16: node {self.index} exited {self.proc.returncode}:\n{self.log_tail()}")
        return scrape(self.metrics_url)

    def subscribe(self, m):
        import threading

        self.ws = m.rpc_client.WSClient(self.host, self.port, timeout=CLI_RPC_S)
        self.ws.subscribe("tm.event = 'NewBlock'")

        def read():
            while not self.ws._closed.is_set():
                ev = self.ws.next_event(timeout=0.5)
                if ev is not None and ev["data"]["type"] == "tendermint/event/NewBlock":
                    self.new_blocks.setdefault(int(ev["data"]["value"]["block"]["header"]["height"]),
                                               time.monotonic())

        threading.Thread(target=read, daemon=True, name=f"cli-node-{self.index}-ws").start()

    def log_tail(self, n=6000):
        self.log_file.flush()
        with open(self.log_path, errors="replace") as f:
            return f.read()[-n:]

    def kill(self):
        import signal

        if self.ws is not None:
            self.ws.close()
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait(10)
        self.log_file.close()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_config(home, gen, **settings):
    """Write gen to home and set the config's {section.key: value}."""
    from tendermint_tpu_torch.config import load_config

    gen.save_as(os.path.join(home, "config", "genesis.json"))
    cfg = load_config(home)
    for key, value in settings.items():
        section, _, attr = key.rpartition(".")
        setattr(getattr(cfg, section) if section else cfg.base, attr, value)
    cfg.save()
    return cfg


def cli_phase(planes, chain_id, built, runs, tmp, sign):
    """Phase 16 on each plane: a testnet from the CLI, a seed and four node
    processes started by it, served over JSON-RPC, NetHarness playing the
    other 146; (b) the heights, (c) txs over RPC, (d) evidence over RPC,
    (e) a fault, (f) a full node joining, (g) the timings; phase 17 in the
    ed25519 network. The harness signs with `sign`, on the pool phases
    14-16 share."""
    m = cli_modules()
    totals = {}
    for kind, P in planes.items():
        _cli_plane(m, kind, P, chain_id, built, sign, runs, totals, os.path.join(tmp, kind))
    check_path("phase 16", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()]
               + [{plane("ed25519").rlc.__name__: 1}])
    return totals


def cli_members(m, out, n):
    """The testnet's validators (kind, public key, (kind, secret)), home by
    home, from each home's priv_validator_key.json."""
    members = []
    for i in range(n):
        cfg_dir = os.path.join(out, f"node{i}", "config")
        pv = m.privval.FilePV.load(os.path.join(cfg_dir, "priv_validator_key.json"),
                                   os.path.join(out, f"node{i}", "data", "priv_validator_state.json"))
        kind = pv.get_pub_key().type_name
        raw = pv.priv_key.bytes()
        members.append((kind, pv.get_pub_key().bytes(), (kind, raw[:32] if kind == "ed25519" else raw)))
    return members


def tx_feed(m):
    """The harness's block builder's mempool: BlockExecutor's replay stub,
    whose reap hands over the txs put in `txs` since the last reap."""

    class TxFeed(m.execution._NopMempool):
        txs = []

        def reap_max_bytes_max_gas(self, max_bytes, max_gas):
            out, self.txs = self.txs, []
            return out

    return TxFeed()


def _cli_plane(m, kind, P, chain_id, built, sign, runs, totals, where):
    import dataclasses

    import torch

    from tendermint_tpu_torch.config import load_config

    dev = torch.device("cuda", 0)
    ed = plane("ed25519")
    H = CLI_HEIGHTS[kind]
    E, L, F = CLI_EQUIVOCATE_AT[kind], CLI_LUNATIC_AT[kind], H + 1
    flood = kind == "ed25519"
    chain = f"{chain_id}-cli-{kind}"
    out = os.path.join(where, "net")
    t0 = time.perf_counter()
    # the testnet, the seed's home and the full node's, each by the CLI, at once
    jobs = [(["testnet", "--validators", str(CS_VALIDATORS), "--key", kind, "--chain-id", chain,
              "--starting-port", "0", "--output", out], None),
            (["init", "seed", "--chain-id", chain], os.path.join(where, "seed")),
            (["init", "full", "--chain-id", chain], os.path.join(where, "full"))]
    if flood:  # phase 18's state-syncing node
        jobs.append((["init", "full", "--chain-id", chain], os.path.join(where, "statesync")))
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda job: cli_command(*job), jobs))
    gen = m.genesis.GenesisDoc.from_file(os.path.join(out, "node0", "config", "genesis.json"))
    gen.consensus_params = dataclasses.replace(gen.consensus_params, timeout=m.params.TimeoutParams(**CLI_TIMEOUTS))
    members = cli_members(m, out, CS_VALIDATORS)
    index_of = {m.keys[k](pub).address(): i for i, (k, pub, _) in enumerate(members)}
    # the nodes' validators propose no height of the run: the harness builds every block
    busy = set(proposer_schedule(m, gen, F + 2))
    chosen = [i for i, (k, pub, _) in enumerate(members) if m.keys[k](pub).address() not in busy][:CLI_NODES]
    log(f"phase 16: {kind} `testnet --validators {CS_VALIDATORS}`, `init seed` and `init full` in "
        f"{time.perf_counter() - t0:.1f} s; the node processes hold homes {chosen}")
    seed_port = free_port()
    seed_home = os.path.join(where, "seed")
    cli_config(seed_home, gen, **{"p2p.laddr": f"tcp://127.0.0.1:{seed_port}", "mode": "seed"})
    seed_id = cli_command(["show-node-id"], seed_home).strip()
    seed_addr = f"{seed_id}@127.0.0.1:{seed_port}"
    node_settings = {"p2p.laddr": "tcp://127.0.0.1:0", "rpc.laddr": "tcp://127.0.0.1:0", "p2p.persistent_peers": "",
                     "p2p.bootstrap_peers": seed_addr, "instrumentation.prometheus": True,
                     "instrumentation.prometheus_listen_addr": "127.0.0.1:0", "mempool.precheck_sigs": True}
    if flood:  # phase 18 restores one of these snapshots
        node_settings["proxy_app"] = f"builtin:kvstore:snapshot={SS_INTERVAL}"
    homes = [os.path.join(out, f"node{i}") for i in chosen]
    for home in homes:
        cli_config(home, gen, **node_settings)
    trigger, dump = os.path.join(where, "fault"), os.path.join(where, "launcher.json")
    message = f"no kernel for device {dev}"
    cli = [sys.executable, "-m", "tendermint_tpu_torch"]
    procs, harness = [], None
    try:
        t_start = time.perf_counter()
        seed = CliNode("seed", seed_home, cli + ["--home", seed_home, "start"], os.path.join(where, "seed.log"))
        procs.append(seed)
        for i, home in enumerate(homes):
            argv = (cli + ["--home", home, "start"] if i != CLI_FAULT_NODE else
                    [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                     f"sys.exit(chip_smoke.cli_launcher({home!r}, {trigger!r}, {dump!r}, {message!r}))"])
            procs.append(CliNode(i, home, argv, os.path.join(where, f"node{i}.log")))
        nodes = procs[1:]
        seed.ready("seed")
        for c in nodes:
            c.ready("node")
            c.client(m)
            c.nid = c.call("status")["node_info"]["id"]
            c.member_addr = m.keys[members[chosen[c.index]][0]](members[chosen[c.index]][1]).address()
            c.wal = load_config(c.home).wal_file  # NetHarness reads it
        first_rpc = {c.index: c.t_first_rpc - c.t_spawn for c in nodes}
        log(f"phase 16: {kind} (a) the seed and {CLI_NODES} node processes started by the CLI in "
            f"{time.perf_counter() - t_start:.1f} s; from `start` to the first RPC answer, s: "
            + json.dumps({i: round(s, 3) for i, s in first_rpc.items()}))
        # (a) the mesh by PEX through the seed; every node switched to consensus
        harness = NetHarness(m, gen, members, sign, nodes, dev, dial="mconn://" + seed_addr)
        harness.builder.mempool = feed = tx_feed(m)
        if flood:  # the nodes' snapshots, taken alike by the replica's app
            harness.replica.client._app.snapshot_interval = SS_INTERVAL
        t0 = time.perf_counter()
        want_peers = lambda c: {o.nid for o in nodes if o is not c} | {harness.nid}  # noqa: E731
        deadline = time.monotonic() + NET_MESH_S + CLI_START_S
        while True:
            infos = [c.call("net_info") for c in nodes]
            meshed = all(want_peers(c) <= {p["node_id"] for p in info["peers"]} for c, info in zip(nodes, infos))
            started = all(c.nid in harness.steps for c in nodes)
            if meshed and started and {c.nid for c in nodes} <= set(harness.pm.peers()):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 16: {kind} (a) the mesh: {json.dumps(infos)[:2000]}; consensus "
                                     f"started at {sorted(harness.steps)}")
            time.sleep(0.1)
        mesh_s = time.perf_counter() - t0
        for c in nodes:
            c.subscribe(m)
        log(f"phase 16: {kind} (a) PEX through the seed meshed the {CLI_NODES} nodes and the harness, and every "
            f"node switched from blocksync to consensus, in {mesh_s * 1e3:.1f} ms; net_info peers: "
            + json.dumps({c.index: int(info["n_peers"]) for c, info in zip(nodes, infos)}))
        seen = {"launches": {}, "rpc_checked": set(), "quiet": {}, "windows": []}
        live = list(nodes)
        scrapes = {c.index: [c.scrape()] for c in nodes}
        cpu0 = {c.index: proc_cpu_s(c.proc.pid) for c in nodes}
        t_committed = {}

        def quiet(label, who=None):
            """Every live node's /metrics now; each node's launches since its
            last quiet point must be what `label`'s window predicts."""
            for c in who or live:
                sample = c.scrape()
                scrapes[c.index].append(sample)
                seen["windows"].append((c.index, label, sample))

        def window(c, want, what, rows=None):
            """Node c's launches (and engine rows on the plane) between its
            last two quiet points, held to want (None: held by the caller)."""
            a, b = scrapes[c.index][-1], scrapes[c.index][-2]
            got = delta(launches_of(a), launches_of(b))
            if want is not None and not counts_match(got, want):
                raise AssertionError(f"phase 16: {kind} {what}: node {c.index} launched {got}, predicted {want}")
            for label, v in got.items():
                name = {"pk_table_build": P.fill, "bitmap_cached": P.hit, "rlc": ed.rlc}[label].__name__
                totals[name] = totals.get(name, 0) + v
            got_rows = delta(engine_rows(a, kind), engine_rows(b, kind))
            if rows is not None and got_rows.get("rows", {}) != rows:
                raise AssertionError(f"phase 16: {kind} {what}: node {c.index} verified rows {got_rows}, "
                                     f"predicted {rows}")
            seen["launches"].setdefault(c.index, []).append((what, got, got_rows))
            return got, got_rows

        def commit_rows(h):
            """The rows of the LastCommit check at height h: the commit of
            h - 1 as block h carries it, its present signatures."""
            return sum(1 for s in harness.proposed[h].last_commit.signatures if not s.absent())

        def rpc_agree(h, who):
            """Each route at a height whose canonical commit every node of
            `who` holds: the same JSON from each."""
            # the indexer takes a block's txs from the event bus on a thread of its own
            n_txs, deadline = str(len(harness.blocks[h].txs)), time.monotonic() + NET_STEP_S
            while not all(c.call("tx_search", query=f"tx.height = {h}")["total_count"] == n_txs for c in who):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 16: {kind} (b) the nodes' index of height {h}'s {n_txs} txs")
                time.sleep(0.05)
            calls = [("block", {"height": h}), ("commit", {"height": h}), ("validators", {"height": h}),
                     ("block_results", {"height": h}), ("abci_query", {"data": b"acct-1".hex()}),
                     ("status", {}), ("tx_search", {"query": f"tx.height = {h}"})]
            answers = {meth: [c.call(meth, **params) for c in who] for meth, params in calls}
            for meth in ("block", "commit", "validators", "block_results", "abci_query", "tx_search"):
                if any(a != answers[meth][0] for a in answers[meth][1:]):
                    raise AssertionError(f"phase 16: {kind} (b) the nodes' {meth} at height {h} differ")
            if answers["commit"][0]["canonical"] is not True:
                raise AssertionError(f"phase 16: {kind} (b) commit at {h} is not canonical")
            if answers["block"][0]["block_id"]["hash"] != harness.bids[h].hash.hex().upper():
                raise AssertionError(f"phase 16: {kind} (b) block {h} over RPC is not the one committed")
            seen["rpc_checked"].add(h)

        # -- the hooks, each between every live node's prevote and the precommits
        def flood_hook(h):
            """(c): 1,024 envelopes in one batch POST to node 0's
            broadcast_tx_async; every node admits them (node 0 from the RPC,
            the others from the gossip); then 1,024 with #517 tampered."""
            quiet(f"height {h}: its LastCommit check")
            for c in live:
                window(c, {"bitmap_cached": 1}, f"height {h}'s LastCommit check", {"bitmap": commit_rows(h)})
            batches = built["ed25519"].batches
            admitted = []
            for label in ("valid", "tampered"):
                _, txs, _ = admission_batch(label, batches[label])
                want_size = len(admitted) + len(txs) - (1 if label == "tampered" else 0)
                t0 = time.perf_counter()
                answers = nodes[0].batch([("broadcast_tx_async", {"tx": tx.hex()}) for tx in txs])
                post_ms = (time.perf_counter() - t0) * 1e3
                if any(a["code"] != 0 for a in answers):
                    raise AssertionError(f"phase 16: {kind} (c) node 0 answered {[a for a in answers if a['code']][:3]}")
                deadline = time.monotonic() + NET_STEP_S
                while not all(int(c.call("num_unconfirmed_txs")["total"]) == want_size for c in live):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"phase 16: {kind} (c) the {label} batch's admission: "
                                             + json.dumps([c.call("num_unconfirmed_txs") for c in live]))
                    time.sleep(0.05)
                seen.setdefault("admit", {})[label] = (post_ms, (time.perf_counter() - t0) * 1e3)
                quiet(f"height {h}: the {label} batch")
                bad = {CS_TAMPER_ENVELOPE} if label == "tampered" else set()
                for c in live:
                    got, got_rows = window(c, None, f"(c) the {label} batch")
                    admission_checks(kind, c, label, got, got_rows, len(txs) - (len(bad) if c.index else 0),
                                     len(bad) if c.index == 0 else 0, 1 if c.index == 0 else len(live) - 1)
                    seen.setdefault("batches", {})[(c.index, label)] = admit_histogram(scrapes[c.index][-1],
                                                                                       scrapes[c.index][-2])
                admitted += [tx for i, tx in enumerate(txs) if i not in bad]
            # #517 in no node's mempool
            import base64

            tampered = admission_batch("tampered", batches["tampered"])[1][CS_TAMPER_ENVELOPE]
            for c in live:
                pages = c.batch([("unconfirmed_txs", {"page": p, "per_page": CLI_PAGE})
                                 for p in range(1, len(admitted) // CLI_PAGE + 2)])
                held = {base64.b64decode(t) for page in pages for t in page["txs"]}
                if len(held) != len(admitted) or tampered in held:
                    raise AssertionError(f"phase 16: {kind} (c) node {c.index}'s unconfirmed_txs hold {len(held)}, "
                                         f"#517 among them: {tampered in held}")
            feed.txs = admitted
            seen["flood"] = admitted

        def commit_hook(h):
            """(c): broadcast_tx_commit of one more envelope at node 0, on a
            thread; its admission gossiped (one row: the host), then the
            harness's next block carries it."""
            import threading

            quiet(f"height {h}: its LastCommit check")
            for c in live:
                window(c, {"bitmap_cached": 1}, f"height {h}'s LastCommit check", {"bitmap": commit_rows(h)})
            tx = built["ed25519"].batches["small"][0][1]
            res = seen["tx_commit"] = {}

            def send():
                t0 = time.perf_counter()
                try:
                    res["answer"] = nodes[0].call("broadcast_tx_commit", tx=tx.hex(), timeout=60)
                except Exception as e:  # noqa: BLE001 - checked after the height
                    res["error"] = repr(e)
                res["ms"] = (time.perf_counter() - t0) * 1e3

            res["thread"] = threading.Thread(target=send, daemon=True, name="tx-commit")
            res["thread"].start()
            deadline = time.monotonic() + NET_STEP_S
            # block h, with the flood's 2,047, is not committed yet
            while not all(int(c.call("num_unconfirmed_txs")["total"]) == len(seen["flood"]) + 1 for c in live):
                if time.monotonic() > deadline or "error" in res:
                    raise AssertionError(f"phase 16: {kind} (c) broadcast_tx_commit's admission: {res}")
                time.sleep(0.02)
            quiet(f"height {h}: broadcast_tx_commit's admission")
            for c in live:
                window(c, {}, "(c) broadcast_tx_commit's admission")
            feed.txs = [tx]
            res["tx"] = tx

        def lunatic_hook(h):
            """(d): the lunatic attack at h - 1 to node 0's broadcast_evidence:
            node 0 checks it (one hit), gossips it, the others check it (one
            hit each); then into the harness's next block."""
            quiet(f"height {h}: its LastCommit check")
            for c in live:
                window(c, {"bitmap_cached": 1}, f"height {h}'s LastCommit check", {"bitmap": commit_rows(h)})
            ev = harness.lunatic(h - 1, b"lunatic")
            rows = net_light_rows(harness.replica.states.load_validators(h - 1), {c.member_addr for c in nodes})
            got = nodes[0].call("broadcast_evidence", evidence=m.evidence.evidence_to_proto(ev).encode().hex())
            if got != {"hash": ev.hash().hex().upper()}:
                raise AssertionError(f"phase 16: {kind} (d) node 0 answered {got}")
            deadline = time.monotonic() + NET_STEP_S
            while not all(launches_of(c.scrape())["bitmap_cached"] > launches_of(scrapes[c.index][-1])["bitmap_cached"]
                          for c in live):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 16: {kind} (d) the attack's checks at every node")
                time.sleep(0.05)
            quiet(f"height {h}: the lunatic attack")
            for c in live:
                window(c, {"bitmap_cached": 1}, "(d) the lunatic attack", {"bitmap": rows})
            harness.add_evidence(ev)
            seen["lunatic"], seen["lunatic_rows"] = ev, rows

        def fault_hook(h):
            """(e): node CLI_FAULT_NODE's device entry points fail; a signed
            envelope to its broadcast_tx_sync is answered -32603 and halts
            it; the others go on."""
            quiet(f"height {h}: its LastCommit check")
            for c in live:
                window(c, {"bitmap_cached": 1}, f"height {h}'s LastCommit check", {"bitmap": commit_rows(h)})
            faulty = nodes[CLI_FAULT_NODE]
            open(trigger, "w").close()
            deadline = time.monotonic() + NET_STEP_S
            while not json.load(open(dump))["fault"]:
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 16: {kind} (e) the launcher did not install the fault")
                time.sleep(0.05)
            seen["launcher"] = json.load(open(dump))
            tx = built["ed25519"].batches["fault"][0][1]
            try:
                faulty.call("broadcast_tx_sync", tx=tx.hex())
                raise AssertionError(f"phase 16: {kind} (e) the faulty node admitted the envelope")
            except m.rpc_client.RPCClientError as e:
                answer = (e.code, str(e))
            want = (-32603, f"RPC error -32603: verifier fault: ValueError: {message}")
            if answer != want:
                raise AssertionError(f"phase 16: {kind} (e) the faulty node answered {answer}, expected {want}")
            halt = f'halting node on fatal failure module=node err="ValueError(\'{message}\')"'
            while halt not in faulty.log_tail(1 << 20):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 16: {kind} (e) no halt in the faulty node's log:\n{faulty.log_tail()}")
                time.sleep(0.05)
            live.remove(faulty)  # height() reads `live` after the hook: the others commit h
            harness.halted.add(faulty.member_addr)
            seen["fault"] = (answer, halt)

        hooks = {E: None, L: lunatic_hook, F: fault_hook}
        if flood:
            hooks.update({CLI_FLOOD_AT: flood_hook, CLI_COMMIT_AT: commit_hook})
        fetch = lambda h: harness.proposed[h].to_proto().encode()  # noqa: E731
        detector, other = nodes[1], nodes[2]
        equivocator = [i for i, v in enumerate(m.state.make_genesis_state(gen).validators.validators)
                       if v.address not in {c.member_addr for c in nodes}][NET_CONFLICT_VALIDATOR]
        top = F + 1 if flood else F  # ed25519: one more height after the fault's
        for h in range(1, top + 1):
            hook = hooks.get(h)
            equivocate = (equivocator, other.nid, detector.nid) if h == E else None
            harness.height(h, live, before_precommits=(lambda h=h, hook=hook: hook(h)) if hook else None,
                           equivocate=equivocate, fetch=fetch, report=True)
            t_committed[h] = time.monotonic()
            quiet(f"height {h}")
            for c in live:
                want = ({} if h == 1 else {"pk_table_build": 1, "bitmap_cached": 1} if h == 2
                        else {} if hook else {"bitmap_cached": 1})
                window(c, want, f"height {h}" + (" after its hook" if hook else ""),
                       None if hook or h == 1 else {"bitmap": commit_rows(h)})
            if h >= 2:
                rpc_agree(h - 1, live)
        # the last height: the nodes idle in the next one's propose step
        rpc_agree_tip = [c.call("block", height=top) for c in live]
        if any(a != rpc_agree_tip[0] for a in rpc_agree_tip[1:]):
            raise AssertionError(f"phase 16: {kind} (b) the nodes' block at {top} differ")
        cpu = {c.index: proc_cpu_s(c.proc.pid) - cpu0[c.index] for c in nodes}  # the halted one idles on
        _cli_checks(kind, nodes, live, harness, seen, H, E, L, F, flood, t_committed)
        if flood:
            _cli_full_node(m, kind, P, gen, harness, where, cli, node_settings, top, L, seen, totals, nodes,
                           procs)
        _cli_timings(kind, nodes, live, harness, seen, H, L, F, flood, t_committed, cpu, mesh_s, runs)
        if flood:  # phases 17 and 18 (a) in the ed25519 network
            _light_daemon(m, kind, P, chain, nodes, harness, where, seen, totals, procs)
            replay = nodes[1].home, nodes[1].call("status")["sync_info"], replay_prediction(P, harness, top)
            ss = _statesync_node(m, kind, P, chain, gen, nodes, harness, where, cli, node_settings, seen, totals,
                                 procs)
    finally:
        if harness is not None:
            harness.close()
        for c in procs:
            c.kill()
    if flood:  # phases 17 (c) and 18 (b), (c), after the network's teardown
        _replay_phase(kind, P, replay[0], replay[1], where, replay[2], totals, runs)
        _store_commands(kind, ss, where)


def admission_checks(kind, c, label, got, got_rows, n_rows, n_rejected, sources):
    """(c)'s admissions at a node, from its /metrics: the envelopes on the
    engine, n_rejected refused, each batch on the plane its size takes (the
    RLC at 256 rows or more, the bitmap at 64-255, the host below 64), an
    RLC launch a two-phase batch, a cache hit a bitmap batch and one more
    for a failed RLC (its bitmap fallback), a fill at most a hit. From one
    source (node 0's RPC) the rows are the n_rows envelopes exactly; from
    the gossip of `sources` peers, at least those and at most one a peer:
    check_tx_batch pre-verifies a batch's candidates before it settles
    them, so an envelope that two peers' frames bring into one batch is
    verified twice, as in the reference (the mempools' equality to the
    admitted set is held apart)."""
    from tendermint_tpu_torch.crypto import ed25519 as ted

    rows, launches = got_rows.get("rows", {}), got_rows.get("launches", {})
    problems = []
    if not n_rows <= sum(rows.values()) <= n_rows * sources or (sources == 1 and sum(rows.values()) != n_rows):
        problems.append(f"rows {rows} sum to {sum(rows.values())}, not {n_rows}"
                        + (f" to {n_rows * sources}" if sources > 1 else ""))
    if got_rows.get("rejected", 0) != n_rejected:
        problems.append(f"{got_rows.get('rejected', 0)} rows refused, not {n_rejected}")
    for path, n in rows.items():
        k = launches.get(path, 0)
        lo, hi = {"two_phase_msm": (ted.MSM_BATCH_CUTOVER, 1 << 30),
                  "bitmap": (ted.DEVICE_BATCH_CUTOVER, ted.MSM_BATCH_CUTOVER - 1)}.get(
            path, (1, ted.DEVICE_BATCH_CUTOVER - 1))
        if not lo * k <= n <= hi * k:
            problems.append(f"{n} rows in {k} {path} batches")
    if got.get("rlc", 0) != launches.get("two_phase_msm", 0):
        problems.append(f"{got.get('rlc', 0)} RLC launches for {launches.get('two_phase_msm', 0)} RLC batches")
    hits, bitmaps = got.get("bitmap_cached", 0), launches.get("bitmap", 0)
    if not bitmaps <= hits <= bitmaps + n_rejected or got.get("pk_table_build", 0) > hits:
        problems.append(f"{hits} hits and {got.get('pk_table_build', 0)} fills for {bitmaps} bitmap batches")
    if problems:
        raise AssertionError(f"phase 16: {kind} (c) the {label} batch at node {c.index}: " + "; ".join(problems)
                             + f" (launches {got}, engine {got_rows})")


def admit_histogram(after, before):
    """The admission batches between two scrapes: their count, txs and
    seconds, and their sizes by the histogram's buckets."""
    name = "tendermint_mempool_admit_batch_size"
    buckets = {}
    for (n, pairs), v in after.items():
        if n == name + "_bucket":
            le = dict(pairs)["le"]
            buckets[le] = int(v - before.get((n, pairs), 0))
    return {"batches": int(metric(after, name + "_count") - metric(before, name + "_count")),
            "txs": int(metric(after, name + "_sum") - metric(before, name + "_sum")),
            "ms": (metric(after, "tendermint_mempool_admit_seconds_sum")
                   - metric(before, "tendermint_mempool_admit_seconds_sum")) * 1e3,
            "le": buckets}


def _cli_checks(kind, nodes, live, harness, seen, H, E, L, F, flood, t_committed):
    """(b) the WebSocket's heights and the RPC's agreement; (c) the txs
    through the kv index and broadcast_tx_commit's height; (d) the
    evidence in the blocks; (e) the fault."""
    import base64

    from tendermint_tpu_torch.eventbus.event_bus import tx_hash

    top = max(t_committed)
    for c in nodes:
        want = range(1, (top if c in live else H) + 1)
        missing = [h for h in want if h not in c.new_blocks]
        if missing:
            raise AssertionError(f"phase 16: {kind} (b) node {c.index}'s WebSocket missed NewBlock at {missing}")
    if seen["rpc_checked"] != set(range(1, top)):
        raise AssertionError(f"phase 16: {kind} (b) RPC agreement checked at {sorted(seen['rpc_checked'])}")
    log(f"phase 16: {kind} (b) every node's block, commit, validators, block_results, abci_query and tx_search "
        f"agree at heights 1-{top - 1} (the faulty node's to {H}); each node's WebSocket got NewBlock at every "
        f"height it committed; launches by window, node 0: "
        + json.dumps([(what, got) for what, got, _ in seen["launches"][0]]))
    # (d)
    dup = {}
    for c in live:
        for h in range(E + 1, top + 1):
            evs = c.call("block", height=h)["block"]["evidence"]["evidence"]
            committed = harness.blocks[h].evidence
            if evs != [ev.to_proto().encode().hex() for ev in committed]:
                raise AssertionError(f"phase 16: {kind} (d) node {c.index}'s block {h} lists {evs}")
            if any(type(ev).__name__ == "DuplicateVoteEvidence" for ev in committed):
                dup.setdefault(c.index, h)
            if h == L + 1 and seen["lunatic"].hash() not in [ev.hash() for ev in committed]:
                raise AssertionError(f"phase 16: {kind} (d) block {h} lacks the lunatic attack")
    if sorted(dup) != sorted(c.index for c in live):
        raise AssertionError(f"phase 16: {kind} (d) DuplicateVoteEvidence committed at {dup}")
    log(f"phase 16: {kind} (d) the lunatic attack at {L - 1}, sent to node 0's broadcast_evidence, was checked "
        f"there and at the other nodes from the gossip, one hit of {seen['lunatic_rows']} rows each, and "
        f"block {L + 1} lists it on every node; the equivocation at {E} became DuplicateVoteEvidence (host), "
        f"committed at {sorted(set(dup.values()))}")
    # (c)
    if flood:
        res = seen["tx_commit"]
        res["thread"].join(NET_STEP_S)
        if res.get("answer", {}).get("height") != str(CLI_COMMIT_AT + 1) or res["answer"]["tx_result"]["code"]:
            raise AssertionError(f"phase 16: {kind} (c) broadcast_tx_commit answered {res}")
        txs = seen["flood"] + [res["tx"]]
        heights = [CLI_FLOOD_AT + 1] * len(seen["flood"]) + [CLI_COMMIT_AT + 1]
        for c in live:
            found = c.batch([("tx", {"hash": tx_hash(tx).hex()}) for tx in txs])
            bad = [i for i, (doc, tx, h) in enumerate(zip(found, txs, heights))
                   if base64.b64decode(doc["tx"]) != tx or doc["height"] != str(h)]
            n = c.call("tx_search", query=f"tx.height = {CLI_FLOOD_AT + 1}")["total_count"]
            if bad or n != str(len(seen["flood"])):
                raise AssertionError(f"phase 16: {kind} (c) node {c.index}'s index: {len(bad)} txs wrong, "
                                     f"tx_search found {n}")
        post = seen["admit"]
        n = len(seen["flood"]) // 2 + 1
        log(f"phase 16: {kind} (c) node 0 took {n} envelopes in one batch POST to broadcast_tx_async "
            f"({post['valid'][0]:.1f} ms for the POST, {post['valid'][1]:.1f} ms to admission at every node), then "
            f"{n} with #{CS_TAMPER_ENVELOPE} tampered ({post['tampered'][0]:.1f} / {post['tampered'][1]:.1f} "
            f"ms), refused there and in no node's unconfirmed_txs; block {CLI_FLOOD_AT + 1} carries the "
            f"{len(seen['flood'])}, "
            f"broadcast_tx_commit's envelope committed at {res['answer']['height']} in {res['ms']:.1f} ms; tx and "
            f"tx_search find all {len(txs)} on every node; each node's admissions by window [launches, engine "
            f"rows and launches by path]: " + json.dumps(
                {c.index: [[what, got, rows] for what, got, rows in seen["launches"][c.index]
                           if what.startswith("(c)")] for c in live}))
    # (e)
    answer, halt = seen["fault"]
    log(f"phase 16: {kind} (e) with node {CLI_FAULT_NODE}'s device entry points failing, broadcast_tx_sync of a "
        f"signed envelope was answered {answer[0]} ({answer[1]!r}), not a CheckTx code, and its log shows "
        f"`{halt}`; the other {len(live)} nodes committed height{f' {F}' if top == F else f's {F}-{top}'} without it, their peers "
        + json.dumps({c.index: sorted(p["node_id"][:8] for p in c.call("net_info")["peers"]) for c in live}))
    for c in live:
        peers = {p["node_id"] for p in c.call("net_info")["peers"]}
        if not ({o.nid for o in live if o is not c} | {harness.nid}) <= peers:
            raise AssertionError(f"phase 16: {kind} (e) node {c.index} lost a live peer: {sorted(peers)}")


def light_rows(vals, commit):
    """The rows of a 2/3 light check of commit: its present signatures in
    the set's order until they pass 2/3 of the power."""
    needed = vals.total_voting_power() * 2 // 3
    tallied = rows = 0
    for v, s in zip(vals.validators, commit.signatures):
        if s.absent():
            continue
        rows += 1
        tallied += v.voting_power
        if tallied > needed:
            break
    return rows


def _cli_full_node(m, kind, P, gen, harness, where, cli, node_settings, top, L, seen, totals, nodes, procs):
    """(f): `init full` and `start` through the CLI with only the seed's
    address; it blocksyncs 1..top - 1 from the live nodes, switches to
    consensus and takes block top from the consensus gossip. Its rows on
    the card are held exactly: each synced block's 2/3 light check of its
    seen commit (the set of that height: the equivocator's power falls
    after the duplicate vote), each block's LastCommit check from height 2
    to top, and the lunatic attack's check in block L + 1; its launches as
    predicted: a fill of the light check's keys and one of the rest, a hit
    a check where the engine does not merge a verify-ahead with a
    LastCommit check (one hit for both where it does)."""
    home = os.path.join(where, "full")
    cli_config(home, gen, **node_settings)
    full = CliNode("full", home, cli + ["--home", home, "start"], os.path.join(where, "full.log"))
    procs.append(full)
    full.ready("node")
    full.client(m)
    states = harness.replica.states
    rows = (sum(light_rows(states.load_validators(h), harness.blocks[h + 1].last_commit) for h in range(1, top))
            + sum(sum(1 for s in harness.blocks[h].last_commit.signatures if not s.absent())
                  for h in range(2, top + 1))
            + (seen["lunatic_rows"] if L + 1 <= top else 0))
    checks = 2 * (top - 1) + (1 if L + 1 <= top else 0)
    progress, deadline = [], time.monotonic() + CLI_SYNC_S
    while True:
        h = int(full.call("status")["sync_info"]["latest_block_height"])
        if not progress or progress[-1][1] != h:
            progress.append((time.monotonic(), h))
        sample = full.scrape()
        if h == top and metric(sample, "tendermint_blocksync_syncing") == 0 \
                and engine_rows(sample, kind)["rows"].get("bitmap", 0) >= rows:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 16: {kind} (f) the full node at {h} of {top - 1} after {CLI_SYNC_S} s:\n"
                                 + full.log_tail())
        time.sleep(0.05)
    got, engine = launches_of(sample), engine_rows(sample, kind)
    if h != top or engine["rows"].get("bitmap") != rows or engine["rows"].get("two_phase_msm") or got["rlc"] \
            or not 1 <= got["pk_table_build"] <= 2 or not (checks + 1) // 2 <= got["bitmap_cached"] <= checks \
            or engine["launches"].get("bitmap") != got["bitmap_cached"]:
        raise AssertionError(f"phase 16: {kind} (f) the full node synced to {h}, launched {got}, engine {engine}; "
                             f"predicted {rows} rows in {checks} checks")
    for label, v in got.items():
        name = {"pk_table_build": P.fill, "bitmap_cached": P.hit}.get(label)
        if name is not None and v:
            totals[name.__name__] = totals.get(name.__name__, 0) + v
    ours, theirs = full.call("block", height=2), nodes[0].call("block", height=2)
    status = full.call("status")
    if ours != theirs or status["sync_info"]["catching_up"] is not False:
        raise AssertionError(f"phase 16: {kind} (f) the full node's block 2 or status differ: {status}")
    synced = [(t, hh) for t, hh in progress if 1 <= hh < top]
    span = synced[-1][0] - synced[0][0]
    seen["full"] = {"blocks": h, "s": progress[-1][0] - full.t_spawn, "blocks_per_s":
                    (synced[-1][1] - synced[0][1]) / span if span > 0 else float("nan"), "launches": got,
                    "rows": engine["rows"], "checks": checks}
    log(f"phase 16: {kind} (f) a full node from `init full` and `start`, knowing only the seed, blocksynced "
        f"1-{top - 1}, switched to consensus and committed {top} from its gossip {seen['full']['s']:.1f} s after "
        f"its start; its block 2 equals node 0's, "
        f"catching_up false; launches {json.dumps(got)} for {checks} checks of {rows} rows (predicted: 1-2 fills, "
        f"{(checks + 1) // 2}-{checks} hits, the rows exactly)")
    return full


def _cli_timings(kind, nodes, live, harness, seen, H, L, F, flood, t_committed, cpu, mesh_s, runs):
    """(g): heights/s; each node's process CPU ms a height, the launcher
    node's consensus-thread busy and CPU ms and card ms a height; the RPC's
    latency by route; broadcast_tx_commit; the WebSocket's NewBlock lag
    after each node's commit; the admission batches; the full node's
    blocks/s."""
    import statistics

    from tendermint_tpu_torch.consensus.round_state import STEP_COMMIT

    hooked = {CLI_FLOOD_AT, CLI_COMMIT_AT} if flood else set()
    hooked |= {L, F}
    top = max(t_committed)
    spans = {h: t_committed[h] - t_committed[h - 1] for h in range(2, top + 1)}
    clean = [h for h in range(2, H + 1) if h not in hooked]
    hps = len(clean) / sum(spans[h] for h in clean) if clean else float("nan")
    log(f"phase 16: {kind} (g) {hps:.3f} heights/s over heights {clean} (no hook paused them); ms a height: "
        + json.dumps({h: round(s * 1e3, 2) for h, s in spans.items()}) + f" on {card()}")
    for c in nodes:
        n = top if c in live else H
        line = f"phase 16: {kind} (g) node {c.index}: process CPU {cpu[c.index] * 1e3 / n:.2f} ms a height"
        if c.index == CLI_FAULT_NODE and "launcher" in seen:
            d = seen["launcher"]
            line += (f"; its consensus thread busy {d['busy_s'] * 1e3 / H:.2f} ms, CPU {d['cpu_s'] * 1e3 / H:.2f} "
                     f"ms a height; the card {sum(ms for _, ms in d['card']) / H:.3f} ms a height between each "
                     f"launch's events, {card_floor(d['card']) / H:.3f} ms at each kernel's fastest "
                     f"({len(d['card'])} launches, {H} heights)")
        log(line + f" on {card()}")
    lat = {}
    for route in ("status", "block", "commit", "validators", "tx_search", "block_results", "abci_query"):
        ms = [x for c in nodes for x in c.rpc_ms.get(route, [])]
        if ms:
            lat[route] = {"median": round(statistics.median(ms), 3), "worst": round(max(ms), 3), "calls": len(ms)}
    lags = [(c.new_blocks[h] - harness.step_times[(c.nid, h, STEP_COMMIT)]) * 1e3
            for c in nodes for h in c.new_blocks if (c.nid, h, STEP_COMMIT) in harness.step_times]
    log(f"phase 16: {kind} (g) RPC ms at {CS_VALIDATORS} validators, by route: " + json.dumps(lat)
        + (f"; the WebSocket's NewBlock after the node's Commit step (as the harness saw it), ms: median "
           f"{statistics.median(lags):.2f}, worst {max(lags):.2f} ({len(lags)} events)" if lags else "")
        + f" on {card()}")
    extra = {}
    if flood:
        log(f"phase 16: {kind} (g) broadcast_tx_commit {seen['tx_commit']['ms']:.1f} ms; admission batches by "
            f"node and batch: " + json.dumps({f"{i} {label}": v for (i, label), v in seen["batches"].items()})
            + f"; the full node {seen['full']['blocks_per_s']:.2f} blocks/s while it synced on {card()}")
        extra = {"tx_commit_s": seen["tx_commit"]["ms"] / 1e3, "full_sync_s": seen["full"]["s"]}
    runs.append({"plane": kind, "run": "CLI network (g)", "commit": CS_VALIDATORS, "s": t_committed[top] -
                 t_committed[1], "heights_per_s": hps, "mesh_s": mesh_s, **extra})


# -- phase 17: the operator's tools inside phase 16's ed25519 network ----------

LIGHT_START_S = 120  # the light daemon's start-up: imports, the trust root's check (its first CUDA use), the proxy
LIGHT_UPDATE_S = 60  # its first update, from the trust root to the tip
LIGHT_PROOF_INDICES = list(range(0, 2047, 32))  # 64 indices of the flood's 2,047-tx block
LIGHT_ROUTE_REPS = 3  # calls of each route, on the proxy and on node 0
REPLAY_S = 300  # a replay process, its imports and first CUDA use included


def cli_counted(dump, args):
    """A CLI command in a process of its own (phase 17's light daemon and
    replays): cli.main(args), with a thread that writes to `dump`, every 0.2 s
    and once more when the command returns, the kernel wrappers' launch
    counts and the seconds since the command was called."""
    import threading

    from tendermint_tpu_torch import cli

    t0, lock = time.perf_counter(), threading.Lock()
    read_counts()  # the kernel modules are imported here, not by the thread beside the command's imports

    def write(done):
        with lock:
            text = json.dumps({"counts": read_counts(), "s": time.perf_counter() - t0, "done": done})
            with open(dump + ".tmp", "w") as f:
                f.write(text)
            os.replace(dump + ".tmp", dump)

    def watch():
        while True:
            write(False)
            time.sleep(0.2)

    threading.Thread(target=watch, daemon=True, name="cli-counted-watch").start()
    rc = cli.main(list(args))
    write(True)
    return rc


def counted_argv(dump, args):
    """`python -u -c` running cli_counted(dump, args): unbuffered, so the
    daemon's lines reach its pipe as it prints them."""
    return [sys.executable, "-u", "-c", f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.cli_counted({dump!r}, {list(args)!r}))"]


def read_dump(path):
    with open(path) as f:
        return json.load(f)


def check_launches(P, checks, cached):
    """The launches of commit checks of valid commits, each given as the
    keys it tallies, by the route its size takes at the default cutovers:
    the host below DEVICE_BATCH_CUTOVER, the cached bitmap below
    MSM_BATCH_CUTOVER (a fill when a key is not in the cache yet, then a
    hit), the RLC from there. `cached` (a set, updated) is the cache's keys."""
    from tendermint_tpu_torch.crypto import ed25519 as ted

    out = {}
    for keys in checks:
        if len(keys) < ted.DEVICE_BATCH_CUTOVER:
            continue
        if len(keys) >= ted.MSM_BATCH_CUTOVER:
            out[P.rlc.__name__] = out.get(P.rlc.__name__, 0) + 1
            continue
        if set(keys) - cached:
            out[P.fill.__name__] = out.get(P.fill.__name__, 0) + 1
            cached |= set(keys)
        out[P.hit.__name__] = out.get(P.hit.__name__, 0) + 1
    return out


def light_keys(vals, commit):
    """The keys verify_commit_light tallies: the commit's signatures for the
    block, by index, until their power passes 2/3 of vals'."""
    needed, tallied, keys = vals.total_voting_power() * 2 // 3, 0, []
    for v, sig in zip(vals.validators, commit.signatures):
        if not sig.for_block():
            continue
        keys.append(v.pub_key.bytes())
        tallied += v.voting_power
        if tallied > needed:
            break
    return keys


def trusting_keys(trusted, commit, frac=(1, 3)):
    """The keys verify_commit_light_trusting tallies: the commit's
    signatures for the block by a validator of the trusted set, until their
    trusted power passes frac of it."""
    needed, tallied, keys = trusted.total_voting_power() * frac[0] // frac[1], 0, []
    for sig in commit.signatures:
        if not sig.for_block():
            continue
        _, v = trusted.get_by_address(sig.validator_address)
        if v is None:
            continue
        keys.append(v.pub_key.bytes())
        tallied += v.voting_power
        if tallied > needed:
            break
    return keys


def replay_keys(vals, commit):
    """The keys verify_commit (validate_block's LastCommit check) batches:
    every signature that is not absent."""
    return [v.pub_key.bytes() for v, sig in zip(vals.validators, commit.signatures) if not sig.absent()]


def ms_stats(ms):
    import statistics

    return {"median": round(statistics.median(ms), 3), "worst": round(max(ms), 3), "calls": len(ms)}


def _light_daemon(m, kind, P, chain, nodes, harness, where, seen, totals, procs):
    """Phase 17 (a), (b), (d) on phase 16's ed25519 network, whose nodes idle
    at the tip: `light` started through the CLI with no device argument,
    node 0 its primary and nodes 1 and 2 its witnesses, trusting height 1;
    its trust root's check and its first update (a skipping step from 1 to
    the tip: the 1/3 trusting check, then the 2/3 light check), launches
    held exactly to the keys each check tallies; the proxy's block,
    commit, header and validators at three heights and proofs_batch and
    light_batch for 64 indices of the 2,047-tx block, held to node 0's
    direct answers with no launch; then SIGTERM, and its process gone
    before the network stops."""
    import base64
    import signal

    from tendermint_tpu_torch.light.http_provider import HTTPProvider

    t_phase = time.perf_counter()
    top = max(harness.blocks)
    flood_h = max(harness.blocks, key=lambda h: len(harness.blocks[h].txs))
    n_txs = len(harness.blocks[flood_h].txs)
    # the prediction, from the light blocks node 0 serves (the daemon's primary)
    primary = HTTPProvider(chain, nodes[0].rpc_url)
    lb1, lb_top = primary.light_block(1), primary.light_block(0)
    if lb_top.height != top or lb1.signed_header.hash() != harness.bids[1].hash:
        raise AssertionError(f"phase 17: {kind} node 0 serves height {lb_top.height} (the tip is {top})")
    checks = [light_keys(lb1.validator_set, lb1.signed_header.commit),  # the trust root
              trusting_keys(lb1.validator_set, lb_top.signed_header.commit),
              light_keys(lb_top.validator_set, lb_top.signed_header.commit)]
    want = check_launches(P, checks, set())
    dump, log_path = os.path.join(where, "light.json"), os.path.join(where, "light.log")
    port = free_port()
    args = ["light", chain, nodes[0].rpc_url, "--witnesses", f"{nodes[1].rpc_url},{nodes[2].rpc_url}",
            "--laddr", f"tcp://127.0.0.1:{port}", "--trusted-height", "1",
            "--trusted-hash", harness.bids[1].hash.hex().upper()]
    daemon = CliNode("light", os.path.join(where, "light"), counted_argv(dump, args), log_path)
    procs.append(daemon)  # _cli_plane's teardown ends it too
    try:
        import queue

        proxy_url, verified, deadline = None, None, time.monotonic() + LIGHT_START_S + LIGHT_UPDATE_S
        while verified is None:
            try:
                line = daemon.lines.get(timeout=max(0.0, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                line = None
            if line is not None:
                if line.startswith("verifying RPC proxy listening on "):
                    proxy_url = line.strip().rsplit(" ", 1)[1]
                    t_proxy = time.monotonic() - daemon.t_spawn
                elif line.startswith("verified head ") and int(line.split()[2]) == top:
                    verified = time.monotonic() - daemon.t_spawn
                elif line.startswith("update error"):
                    raise AssertionError(f"phase 17: {kind} (a) the light daemon: {line.strip()}\n{daemon.log_tail()}")
            elif daemon.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"phase 17: {kind} (a) the light daemon did not verify the tip {top} within "
                                     f"{LIGHT_START_S + LIGHT_UPDATE_S} s (exit code {daemon.proc.poll()}):\n"
                                     + daemon.log_tail())
        if proxy_url is None or proxy_url != f"http://127.0.0.1:{port}":
            raise AssertionError(f"phase 17: {kind} (a) the proxy's address: {proxy_url}")
        time.sleep(0.5)  # the dump thread's next write
        got = {k: v for k, v in read_dump(dump)["counts"].items() if v}
        if got != want:
            raise AssertionError(f"phase 17: {kind} (a) the light daemon launched {got}, predicted {want} for "
                                 f"checks of {[len(k) for k in checks]} keys")
        log(f"phase 17: {kind} (a) `light` (no device argument) trusted height 1 and verified the tip {top} "
            f"{verified:.1f} s after its start (its proxy up at {t_proxy:.1f} s): the trust root's 2/3 check "
            f"of {len(checks[0])} keys, then one skipping step 1 -> {top}: the 1/3 trusting check of "
            f"{len(checks[1])} keys and the 2/3 check of {len(checks[2])}; launches {json.dumps(got)}, as "
            f"predicted")
        for name, v in got.items():
            totals[name] = totals.get(name, 0) + v
        # (b) the proxy's routes against node 0's, no launch
        proxy = m.rpc_client.HTTPClient(proxy_url, timeout=CLI_RPC_S)
        direct = nodes[0]
        heights = [2, flood_h, top - 1]
        ms = {"proxy": {}, "direct": {}}

        def both(route, params, at_node=None):
            """The route on the proxy and on node 0 (at_node: node 0's
            answer in the proxy's form), LIGHT_ROUTE_REPS times each, in
            turns; the answers must be equal JSON."""
            at_node = at_node or (lambda: direct.rpc.call(route, **params))
            answers = {}
            for _ in range(LIGHT_ROUTE_REPS):
                for side, call in (("proxy", lambda: proxy.call(route, **params)), ("direct", at_node)):
                    t0 = time.perf_counter()
                    answers[side] = call()
                    ms[side].setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
            a, b = answers["proxy"], answers["direct"]
            if json.dumps(a, sort_keys=True) != json.dumps(b, sort_keys=True):
                raise AssertionError(f"phase 17: {kind} (b) the proxy's {route} {params} differs from node 0's: "
                                     f"{json.dumps(a)[:1500]} != {json.dumps(b)[:1500]}")
            return a

        def header_fields(h):
            """Node 0's header at h in the fields the proxy serves of the
            verified header (ref: light/proxy.py header)."""
            hd = direct.rpc.call("header", height=h)["header"]
            return {"header": {"chain_id": hd["chain_id"], "height": hd["height"], "time": hd["time"],
                               "app_hash": hd["app_hash"], "validators_hash": hd["validators_hash"],
                               "next_validators_hash": hd["next_validators_hash"],
                               "proposer_address": hd["proposer_address"],
                               "last_block_id": {"hash": hd["last_block_id"]["hash"]}}}

        def validator_fields(h):
            """Node 0's validator set at h, every page of 100, in the form the
            proxy serves the verified set: unpaginated, no proposer priority."""
            pages, total = [], None
            while total is None or sum(len(p) for p in pages) < total:
                res = direct.rpc.call("validators", height=h, page=len(pages) + 1, per_page=CLI_PAGE)
                pages.append(res["validators"])
                total = int(res["total"])
            vals = [{k: v[k] for k in ("address", "pub_key", "voting_power")} for p in pages for v in p]
            return {"block_height": res["block_height"], "validators": vals, "count": str(total),
                    "total": str(total)}

        before = read_dump(dump)["counts"]
        for h in heights:
            both("block", {"height": h})
            both("commit", {"height": h})
            both("header", {"height": h}, lambda h=h: header_fields(h))
            both("validators", {"height": h}, lambda h=h: validator_fields(h))
        proofs = both("proofs_batch", {"height": flood_h, "indices": LIGHT_PROOF_INDICES})
        batch = both("light_batch", {"height": flood_h, "indices": LIGHT_PROOF_INDICES})
        if len(proofs["txs"]) != len(LIGHT_PROOF_INDICES) or base64.b64decode(proofs["txs"][0]) \
                != harness.blocks[flood_h].txs[0] or len(batch["validators"]) != CS_VALIDATORS:
            raise AssertionError(f"phase 17: {kind} (b) proofs_batch gave {len(proofs['txs'])} txs, light_batch "
                                 f"{len(batch['validators'])} validators")
        time.sleep(0.5)
        routes_launched = delta(read_dump(dump)["counts"], before)
        if routes_launched:
            raise AssertionError(f"phase 17: {kind} (b) the proxy's routes launched {routes_launched}; a header "
                                 f"already verified, or linked back by hash, launches nothing")
        lat = {side: {route: ms_stats(v) for route, v in by.items()} for side, by in ms.items()}
        log(f"phase 17: {kind} (b) the proxy's block, commit at heights {heights} equal node 0's answers, its "
            f"header and validators equal node 0's in the fields it serves; proofs_batch and light_batch of "
            f"{len(LIGHT_PROOF_INDICES)} indices of the {n_txs}-tx block {flood_h} equal node 0's; no launch")
        log(f"phase 17: {kind} (b) ms by route, the proxy (verified) against node 0 (direct), at "
            f"{CS_VALIDATORS} validators: " + json.dumps(lat) + f" on {card()}")
        seen["light"] = {"verified_s": verified, "proxy_s": t_proxy, "ms": lat}
    finally:
        # (d) SIGTERM to the daemon; it must be gone before the network stops
        if daemon.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(daemon.proc.pid, signal.SIGTERM)
        try:
            daemon.proc.wait(REAP_GRACE_S)
        except subprocess.TimeoutExpired:
            daemon.kill()
            raise AssertionError(f"phase 17: {kind} (d) the light daemon outlived SIGTERM by {REAP_GRACE_S} s")
        daemon.kill()
    left = [pid for pid, (_, pgrp, session, state, _cmd) in proc_table().items()
            if daemon.proc.pid in (pgrp, session) and state not in ("Z", "X")]
    if left:
        raise AssertionError(f"phase 17: {kind} (d) processes of the light daemon's session outlived it: {left}")
    log(f"phase 17: {kind} (d) SIGTERM ended the light daemon (exit {daemon.proc.returncode}), nothing of its "
        f"session left, before the network stops; (a), (b), (d) in {time.perf_counter() - t_phase:.1f} s")


def replay_prediction(P, harness, top):
    """The launches of `replay` on a copy of a node's home whose state store
    holds the genesis state alone: every stored block through apply_block,
    each LastCommit (heights 2..top) checked through verify_commit; on the
    copy as it stands, where the state covers every block, none (the blocks
    go to the app alone)."""
    states = harness.replica.states
    checks = [replay_keys(states.load_validators(h - 1), harness.blocks[h].last_commit)
              for h in range(2, top + 1)]
    return check_launches(P, checks, set()), [len(k) for k in checks]


def _replay_phase(kind, P, home, node_status, where, prediction, totals, runs):
    """Phase 17 (c), after the network's teardown: `replay` (no device
    argument) on two copies of a validator's home, at once: as it stands
    (the app behind the whole stored chain: each block re-executed on the
    app alone, as the state covers it: no commit to check) and with its
    state store holding the genesis state alone, as a node's first start
    saves it (each block through apply_block, its LastCommit checked on the
    card). Beside them, phase 18 (b): `replay --app grpc://...` on a third
    copy at genesis, the app the port's kvstore behind the port's
    GRPCServer in a process of its own. Each ends at the app hash the node
    reported over RPC; launches as predicted; blocks/s."""
    from tendermint_tpu_torch.state import StateStore, make_genesis_state
    from tendermint_tpu_torch.store.kv import FileDB
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    want, rows = prediction
    t_phase = time.perf_counter()
    height, app_hash = int(node_status["latest_block_height"]), node_status["latest_app_hash"]
    genesis, over_grpc = "with its state at genesis", "with its state at genesis, its app over gRPC"
    copies = {"as it stands": os.path.join(where, "replay-home"), genesis: os.path.join(where, "replay-genesis"),
              over_grpc: os.path.join(where, "replay-grpc")}
    for path in copies.values():
        shutil.copytree(home, path)
    for label in (genesis, over_grpc):
        state_db = os.path.join(copies[label], "data", "state.db")
        os.remove(state_db)
        db = FileDB(state_db)
        StateStore(db).save(make_genesis_state(GenesisDoc.from_file(os.path.join(home, "config", "genesis.json"))))
        db.close()
    app, app_addr = app_process(where, "grpc-app", "grpc://127.0.0.1:0")
    procs = {}
    try:
        for label, path in copies.items():
            dump = path + ".json"
            args = ["--home", path, "replay"] + (["--app", app_addr] if label == over_grpc else [])
            procs[label] = dump, start_process(counted_argv(dump, args), cwd=ROOT, env=cli_env(),
                                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                                start_new_session=True)
        _replay_checks(kind, procs, genesis, over_grpc, copies, app_addr, height, app_hash, want, rows, totals,
                       runs, t_phase)
    finally:
        app.kill()
    log(f"phase 17: {kind} (c) both replays, and phase 18 (b)'s, in {time.perf_counter() - t_phase:.1f} s")


def _replay_checks(kind, procs, genesis, over_grpc, copies, app_addr, height, app_hash, want, rows, totals, runs,
                   t_phase):
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.store.kv import FileDB

    for label, (dump, proc) in procs.items():
        tag = "phase 18: {} (b)" if label == over_grpc else "phase 17: {} (c)"
        tag = tag.format(kind)
        try:
            out, err = proc.communicate(timeout=REPLAY_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{tag} replay {label} ran past {REPLAY_S} s") from None
        if proc.returncode:
            raise AssertionError(f"{tag} replay {label} exited {proc.returncode}:\n{err[-4000:]}")
        expect = f"replayed to height {height} (app hash {app_hash[:16]})"
        res = read_dump(dump)
        got = {k: v for k, v in res["counts"].items() if v}
        predicted = want if label in (genesis, over_grpc) else {}
        if expect not in out or not res["done"] or got != predicted:
            raise AssertionError(f"{tag} replay {label}: {out.strip()!r}, launched {got}; expected "
                                 f"{expect!r}, launches {predicted}")
        if label in (genesis, over_grpc):
            state_db = os.path.join(copies[label], "data", "state.db")
            db = FileDB(state_db)
            rebuilt = StateStore(db).load()
            db.close()
            if rebuilt.last_block_height != height or rebuilt.app_hash.hex().upper() != app_hash:
                raise AssertionError(f"{tag} the rebuilt state is at {rebuilt.last_block_height}, "
                                     f"app hash {rebuilt.app_hash.hex().upper()}; the node reported {height}, "
                                     f"{app_hash}")
            for name, v in got.items():
                totals[name] = totals.get(name, 0) + v
        log(f"{tag} `replay` (no device argument) on a copy of node 1's home {label}"
            + (f" ({app_addr})" if label == over_grpc else "") + ": "
            f"{out.strip()}, node 1's app hash over RPC {app_hash}; {height / res['s']:.2f} blocks/s over "
            f"{res['s']:.2f} s in cli.main (the process {time.perf_counter() - t_phase:.2f} s so far); launches "
            f"{json.dumps(got)}, predicted {json.dumps(predicted)}"
            + (f" (LastCommit checks of {rows} keys)" if predicted else "") + f" on {card()}")
        runs.append({"plane": kind, "run": f"replay {label} ({'18 b' if label == over_grpc else '17 c'})",
                     "commit": CS_VALIDATORS, "s": res["s"],
                     "blocks_per_s": height / res["s"]})


# -- phase 18: state sync and the remote app clients in phase 16's ed25519 network --

SS_INTERVAL = 4  # the validators' `builtin:kvstore:snapshot=N`: snapshots at 4 and 8 below the tip 10
SS_RESTORE_S = 180  # the state-syncing node: start-up, discovery, 40-odd chunks, the backfill, the tail


def app_process(where, name, addr):
    """The port's kvstore behind the port's socket (tcp://, unix://) or gRPC
    (grpc://) server, in a process of its own (`python -m
    tendermint_tpu_torch.abci.socket --addr ADDR`): a CliNode whose
    start-up line is awaited; its listening address."""
    import queue

    app = CliNode(name, where, [sys.executable, "-u", "-m", "tendermint_tpu_torch.abci.socket", "--addr", addr],
                  os.path.join(where, f"{name}.log"))
    deadline = time.monotonic() + CLI_START_S
    while True:
        try:
            line = app.lines.get(timeout=1.0)
        except queue.Empty:
            line = None
        if line is not None and line.startswith("ABCI kvstore listening on "):
            return app, line.strip().rsplit(" ", 1)[1]
        if app.proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"phase 18: the {name} app did not start within {CLI_START_S} s (exit code "
                                 f"{app.proc.poll()}):\n{app.log_tail()}")


def statesync_prediction(P, harness, lbs, h, top):
    """The keys each check of the state-syncing node tallies, in order: the
    light client's trust root at 1 (2/3), its skipping step 1 -> h + 1 (the
    1/3 trusting check, then 2/3), the adjacent step to h + 2 (2/3);
    blocksync's light check and validate_block's LastCommit check of each
    block h + 1 .. top - 1; the LastCommit check of block top, which comes
    from the consensus gossip. Returns (launches, keys a check)."""
    states = harness.replica.states
    checks = [light_keys(lbs[1].validator_set, lbs[1].signed_header.commit),
              trusting_keys(lbs[1].validator_set, lbs[h + 1].signed_header.commit),
              light_keys(lbs[h + 1].validator_set, lbs[h + 1].signed_header.commit),
              light_keys(lbs[h + 2].validator_set, lbs[h + 2].signed_header.commit)]
    for x in range(h + 1, top):
        checks += [light_keys(states.load_validators(x), harness.blocks[x + 1].last_commit),
                   replay_keys(states.load_validators(x - 1), harness.blocks[x].last_commit)]
    checks.append(replay_keys(states.load_validators(top - 1), harness.blocks[top].last_commit))
    return check_launches(P, checks, set()), [len(k) for k in checks]


def _statesync_node(m, kind, P, chain, gen, nodes, harness, where, cli, node_settings, seen, totals, procs):
    """Phase 18 (a) on phase 16's ed25519 network at its tip: the port's
    kvstore behind its SocketServer in a process of its own; a node from
    `init full` and `start` (no device argument), knowing only the seed,
    with statesync.enable, nodes 0 and 1 its RPC servers, the trust root
    node 0's block 1, and its app at tcp://: it restores the newest
    snapshot through the socket client, backfills, blocksyncs and takes the
    tip from the gossip. Held: its app hash and the state it bootstrapped
    (the validator sets at h + 1 and h + 2 and the params, read back over
    its RPC) equal node 0's; its status channels equal node 0's; its
    StateSyncMetrics count the snapshots and the chunks; its launches
    exactly those the keys of each check predict."""
    from tendermint_tpu_torch.light.http_provider import HTTPProvider

    t_phase = time.perf_counter()
    top = max(harness.blocks)
    snaps = harness.replica.client._app._snapshots
    h = max(snaps)
    snap, chunks = snaps[h]
    if h > top - 2:
        raise AssertionError(f"phase 18: {kind} (a) the newest snapshot {h} lies less than two heights below the "
                             f"tip {top}")
    primary = HTTPProvider(chain, nodes[0].rpc_url)
    lbs = {x: primary.light_block(x) for x in (1, h + 1, h + 2)}
    want, sizes = statesync_prediction(P, harness, lbs, h, top)
    log(f"phase 18: {kind} (a) the replica holds snapshots {sorted(snaps)}; the node must restore {h} "
        f"({snap.chunks} chunks, {sum(map(len, chunks))} bytes, hash {snap.hash.hex()[:16]}), its checks of "
        f"{sizes} keys predicted to launch {json.dumps(want)}")
    app, app_addr = app_process(where, "socket-app", "tcp://127.0.0.1:0")
    procs.append(app)
    home = os.path.join(where, "statesync")
    trust = nodes[0].call("commit", height=1)["signed_header"]["commit"]["block_id"]["hash"]
    cli_config(home, gen, **{**node_settings, "mode": "full", "proxy_app": app_addr, "statesync.enable": True,
                             "statesync.rpc_servers": f"{nodes[0].rpc_url},{nodes[1].rpc_url}",
                             "statesync.trust_height": 1, "statesync.trust_hash": trust.lower()})
    node = CliNode("statesync", home, cli + ["--home", home, "start"], os.path.join(where, "statesync.log"))
    procs.append(node)
    node.ready("node")
    node.client(m)
    tip_hash = nodes[0].call("abci_info")["response"]["last_block_app_hash"]
    marks, deadline = {}, time.monotonic() + SS_RESTORE_S
    while True:
        sample = node.scrape()
        now = time.monotonic() - node.t_spawn
        if metric(sample, "tendermint_statesync_total_snapshots") and "discovered" not in marks:
            marks["discovered"] = now
        if metric(sample, "tendermint_statesync_chunks_applied") and "first chunk" not in marks:
            marks["first chunk"] = now
        status = node.call("status")["sync_info"]
        height = int(status["latest_block_height"])
        if height >= h and "restored" not in marks and metric(sample, "tendermint_statesync_chunks_applied") \
                == snap.chunks:
            marks["restored"] = now
        got = {label: v for label, v in launches_of(sample).items() if v}
        if height == top and not status["catching_up"] and \
                node.call("abci_info")["response"]["last_block_app_hash"] == tip_hash and \
                sum(got.values()) >= sum(want.values()):
            marks["caught up"] = now
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 18: {kind} (a) the state-syncing node at {height} of {top}, launches "
                                 f"{got}, after {SS_RESTORE_S} s:\n{node.log_tail()}")
        time.sleep(0.1)
    time.sleep(0.5)  # a launch past the prediction would show in the next scrape
    sample = node.scrape()
    names = {"pk_table_build": P.fill.__name__, "bitmap_cached": P.hit.__name__, "rlc": P.rlc.__name__}
    got = {names[label]: v for label, v in launches_of(sample).items() if v}
    applied = int(metric(sample, "tendermint_statesync_chunks_applied"))
    discovered = int(metric(sample, "tendermint_statesync_total_snapshots"))
    retries = {dict(p).get("result"): int(v) for (n, p), v in sample.items()
               if n == "tendermint_statesync_chunk_retries_total" and v}
    if got != want or applied != snap.chunks or discovered != len(snaps):
        raise AssertionError(f"phase 18: {kind} (a) the state-synced node launched {got} (predicted {want}), "
                             f"applied {applied} chunks of {snap.chunks}, discovered {discovered} snapshots of "
                             f"{len(snaps)}")
    for name, v in got.items():
        totals[name] = totals.get(name, 0) + v
    # the state it bootstrapped at h, read back over its RPC (its sets of h + 1
    # and h + 2; the RPC serves nothing below its lowest block, h + 1), and its channels
    for x in (h + 1, h + 2):
        if validator_pages(node, x) != validator_pages(nodes[0], x):
            raise AssertionError(f"phase 18: {kind} (a) the state-synced node's validators at {x} differ")
    params = [c.call("consensus_params", height=h + 1) for c in (node, nodes[0])]
    restored_hash = nodes[0].call("header", height=h + 1)["header"]["app_hash"]
    ours, theirs = node.call("status"), nodes[0].call("status")
    blocks = [c.call("block", height=top) for c in (node, nodes[0])]
    if params[0] != params[1] or ours["node_info"]["channels"] != theirs["node_info"]["channels"] \
            or not {0x60, 0x61, 0x62, 0x63} <= set(bytes.fromhex(ours["node_info"]["channels"])) \
            or blocks[0] != blocks[1] or ours["sync_info"]["latest_app_hash"] != theirs["sync_info"]["latest_app_hash"]:
        raise AssertionError(f"phase 18: {kind} (a) the state-synced node's params, channels, block {top} or app "
                             f"hash differ from node 0's: {json.dumps(ours)[:1500]}")
    cpu = proc_cpu_s(node.proc.pid)
    log(f"phase 18: {kind} (a) the kvstore in a process of its own behind the socket client ({app_addr}); a "
        f"node from `init full` and `start`, knowing only the seed, restored snapshot {h} by state sync "
        f"({applied} chunks applied, as many as it has; {discovered} snapshots discovered; chunk re-requests "
        f"{json.dumps(retries)}), backfilled, blocksynced and took the tip {top} from the gossip; its app hash "
        f"{ours['sync_info']['latest_app_hash'][:16]} is node 0's, node 0's header {h + 1} carries the restored "
        f"{restored_hash[:16]}; its validators at {h + 1}-{h + 2}, params at {h + 1}, block {top} and status "
        f"channels ({ours['node_info']['channels']}) equal node 0's")
    log(f"phase 18: {kind} (a) its launches {json.dumps(got)}, as predicted (checks of {sizes} keys: the trust "
        f"root, the trusting and 2/3 checks to {h + 1}, the 2/3 check of {h + 2}, blocksync's light and "
        f"LastCommit checks of {', '.join(str(x) for x in range(h + 1, top))}, the LastCommit check of {top}); "
        f"from its start, s: {json.dumps({k: round(v, 3) for k, v in marks.items()})}; the snapshot "
        f"{snap.chunks} chunks, {sum(map(len, chunks))} bytes; its CPU {cpu:.1f} s; (a) in "
        f"{time.perf_counter() - t_phase:.1f} s on {card()}")
    seen["statesync"] = {"marks": marks, "launches": got, "cpu_s": cpu, "chunks": snap.chunks}
    return SimpleNamespace(home=home, top=top, tip_header=nodes[0].call("header", height=top))


def validator_pages(c, height):
    """A node's validators at height, every page, in the fields the set's
    hash covers (address, key, power)."""
    pages, total = [], None
    while total is None or sum(len(p) for p in pages) < total:
        res = c.call("validators", height=height, page=len(pages) + 1, per_page=CLI_PAGE)
        pages.append(res["validators"])
        total = int(res["total"])
    return [(v["address"], v["pub_key"], v["voting_power"]) for p in pages for v in p]


def _store_commands(kind, ss, where):
    """Phase 18 (c), after the teardown, on a copy of the state-synced node's
    home (stopped): `rollback`, then `key-migrate` twice, through cli.main.
    Held to the reference's effects: the state one height back, at the
    block and app hash node 0's header of the tip names; the second
    migrate a no-op (every database byte for byte as the first left it);
    no launch."""
    import hashlib
    import io

    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.store.kv import FileDB

    t0 = time.perf_counter()
    home = os.path.join(where, "commands-home")
    shutil.copytree(ss.home, home)
    before = read_counts()

    def run(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--home", home] + args)
        if rc:
            raise AssertionError(f"phase 18: {kind} (c) `{' '.join(args)}` exited {rc}:\n{out.getvalue()}")
        return out.getvalue().strip()

    def digests():
        data = load_config(home).db_dir
        return {name: hashlib.sha256(open(os.path.join(data, name), "rb").read()).hexdigest()
                for name in sorted(os.listdir(data)) if name.endswith(".db")}

    header = ss.tip_header["header"]
    rolled = run(["rollback"])
    want = f"rolled back state to height {ss.top - 1} and hash {header['app_hash']}"
    db = FileDB(os.path.join(load_config(home).db_dir, "state.db"))
    state = StateStore(db).load()
    db.close()
    if rolled != want or state.last_block_height != ss.top - 1 \
            or state.last_block_id.hash.hex().upper() != header["last_block_id"]["hash"] \
            or state.app_hash.hex().upper() != header["app_hash"]:
        raise AssertionError(f"phase 18: {kind} (c) rollback said {rolled!r} (expected {want!r}); the state at "
                             f"{state.last_block_height}, block {state.last_block_id.hash.hex()}")
    first = run(["key-migrate"])
    after_first = digests()
    second = run(["key-migrate"])
    launched = delta(read_counts(), before)
    if not second.endswith("total migrated: 0 keys") or digests() != after_first or launched:
        raise AssertionError(f"phase 18: {kind} (c) key-migrate twice: {first!r}, then {second!r}; the databases "
                             f"{'changed' if digests() != after_first else 'unchanged'}; launches {launched}")
    log(f"phase 18: {kind} (c) on a copy of the state-synced node's home: `rollback`: {rolled!r}, the state "
        f"at {state.last_block_height}, its block and app hash those node 0's header {ss.top} names; "
        f"`key-migrate`: {first.splitlines()[-1]!r}, then {second.splitlines()[-1]!r} with "
        f"{len(after_first)} databases byte for byte unchanged; no launch; {time.perf_counter() - t0:.1f} s")


ALL_PHASES = frozenset(range(4, 17))


def selected_phases(text):
    """The phases among 4-16 a run drives: all of them, or the list given
    (13 needs 12's chains)."""
    if not text:
        return ALL_PHASES
    chosen = {int(x) for x in text.split(",") if x.strip()}
    if not chosen <= ALL_PHASES:
        raise SystemExit(f"--phases: {sorted(chosen - ALL_PHASES)} not among 4-16")
    return frozenset(chosen | ({12} if 13 in chosen else set()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every key, message and scalar")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after holding the kernels against their plain versions")
    ap.add_argument("--phases", metavar="LIST",
                    help="a partial run: only these of phases 4-16 (e.g. 12,16; 13 brings 12, 16 brings 17 "
                         "and 18), after phases 1-3; it prints no result line")
    ap.add_argument("--ab-parent", metavar="DIR",
                    help="after phase 4, time the RLC kernels, the uncached bitmaps, the fills and "
                         "the cache hits of the tree unpacked at DIR against this tree's, in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the exact-launch phases run with the cutovers fixed: the autotune's
    # probe launches from a thread at an unknown time (phase 8 runs it)
    os.environ["TM_TPU_AUTOTUNE"] = "off"
    # the main path's host prep is the native one; phase 4 times both routes
    os.environ.pop("TM_TPU_NATIVE", None)
    sys.path.insert(0, ROOT)
    try:
        from tendermint_tpu_torch import native  # noqa: F401
        from tendermint_tpu_torch.ops import _build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2

    import signal
    import tempfile

    # a SIGTERM (a time limit's, say) unwinds through the
    # finally below, which ends every process the script started
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    # every home and temporary directory of the run lies under one root,
    # the children's TMPDIR too: the audit names a process by it
    run_tmp = tempfile.mkdtemp(prefix="chip-smoke-run-")
    RUN_DIRS.append(run_tmp)
    tempfile.tempdir = os.environ["TMPDIR"] = run_tmp
    try:
        return run_phases(args)
    finally:
        reap_all()
        shutil.rmtree(run_tmp, ignore_errors=True)


def run_phases(args) -> int:
    """Phases 1-18 (17 and 18 inside phase 16's ed25519 network), then the
    audit of every process the script started, then the last three lines.
    The kernels' nvcc builds run in a thread while the set-up signs on the
    pool, which phases 12-16 share."""
    import multiprocessing
    import tempfile
    import threading

    import torch

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.ops import _build

    import numpy as np

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    t_start = time.perf_counter()
    chosen = selected_phases(args.phases)
    dev = torch.device("cuda", 0)
    card_line = card()
    clock_mhz = float(nvidia_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {sms} SMs at {clock_mhz:.0f} MHz max")

    # phase 1: the native host prep, then the kernels, built beside the set-up
    t0 = time.perf_counter()
    cmd = native.build()
    log(f"phase 1: native host prep: `{' '.join(cmd or native.command(native.target()))}` "
        + (f"built in {time.perf_counter() - t0:.1f} s" if cmd else "(already built)"))
    native.load_prep()
    built = {}

    def build_kernels():
        t = time.perf_counter()
        try:
            built["reports"] = _build.build_all()
        except BaseException as e:  # raised in the main thread below
            built["error"] = e
        built["s"] = time.perf_counter() - t

    build_thread = threading.Thread(target=build_kernels, daemon=True, name="nvcc-build")
    build_thread.start()

    rng = np.random.default_rng(args.seed)
    planes = {kind: plane(kind) for kind in PLANES}
    chain_id = "chip-smoke"
    workers = max(1, min(8, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    tmp12 = tempfile.mkdtemp(prefix="chip-smoke-state-")
    with ctx.Pool(workers) as pool:  # the set-up and phases 12-16 sign on one pool
        t0 = time.perf_counter()
        keys = {}
        if not args.kernels_only:
            for kind in PLANES:
                t1 = time.perf_counter()
                seeds = [rng.bytes(32) for _ in range(SIZES[-1])]
                keys[kind] = seeds, make_keys(pool, kind, seeds)
                log(f"phase 3: {len(seeds)} {kind} validator keys in {time.perf_counter() - t1:.1f} s")
            commits = main_commits(pool, rng, keys, chain_id)
            if 9 in chosen:
                t1 = time.perf_counter()
                commits9 = engine_commits(pool, rng, keys, chain_id)
                log(f"phase 9: its commits signed in {time.perf_counter() - t1:.1f} s")
            if 10 in chosen:
                t1 = time.perf_counter()
                chains10, mixed10 = light_setup(pool, rng, chain_id)
                log(f"phase 10: its light chains and mixed-key commits signed in {time.perf_counter() - t1:.1f} s")
            if 11 in chosen:
                t1 = time.perf_counter()
                chains11 = client_setup(pool, rng, chain_id)
                log(f"phase 11: its rotating chains, forged blocks and votes signed in "
                    f"{time.perf_counter() - t1:.1f} s")
            if chosen & {14, 15, 16}:
                t1 = time.perf_counter()
                built14 = consensus_setup(pool, rng, chain_id)
                log(f"phase 14: its validator keys and signed-tx envelopes made in {time.perf_counter() - t1:.1f} s")
            log(f"set-up signed during the build in {time.perf_counter() - t0:.1f} s")
        build_thread.join()
        if "error" in built:
            raise built["error"]
        reports = built["reports"]
        log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in {built['s']:.1f} s")
        for name, rep in reports.items():
            for fn, regs, spills in ptxas_functions(rep):
                log(f"phase 1: {name}: {fn}: {regs} registers, {spills}")

        errs = {}
        for P in planes.values():
            errs.update(check_kernels(rng, dev, P))
        errs.update(check_fail_count(rng, dev))
        if args.kernels_only:
            audit_or_fail()
            log(f"kernels only: stopping after phase 2 on {card_line}")
            return 0
        bad_index, counts, runs = main_path(commits, chain_id)
        if 12 in chosen:
            t0 = time.perf_counter()
            built12 = state_setup(pool, rng, chain_id, tmp12)
            log(f"phase 12: its source chains signed and applied, and the lunatic blocks signed, in "
                f"{time.perf_counter() - t0:.1f} s")
        if 13 in chosen:
            t0 = time.perf_counter()
            blocksync_setup(pool, chain_id, built12)
            log(f"phase 13: its extended commits' extension signatures signed in {time.perf_counter() - t0:.1f} s")
        kernels = []
        if 4 in chosen:
            for kind, P in planes.items():
                kernels += kernels_at_main_path(P, dev, rng, chain_id, commits[kind], bad_index, counts, errs,
                                                int32_rate, runs)
        if args.ab_parent:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                ab_parent(planes, dev, chain_id, commits, bad_index, rng, os.path.abspath(args.ab_parent), tmp)
            log(f"phase 4: the A/B against {args.ab_parent} in {time.perf_counter() - t0:.1f} s")
        if 5 in chosen:
            t0 = time.perf_counter()
            kernels += geometry_path(planes, dev, chain_id, commits, bad_index, errs, int32_rate, runs)
            log(f"phase 5: the cache geometries in {time.perf_counter() - t0:.1f} s")
        if 6 in chosen:
            t0 = time.perf_counter()
            kernels += rlc_cache_path(planes["ed25519"], dev, rng, chain_id, commits["ed25519"], bad_index,
                                      errs, int32_rate, runs)
            log(f"phase 6: the cached RLC in {time.perf_counter() - t0:.1f} s")
        if 7 in chosen:
            t0 = time.perf_counter()
            meshes = {"1": SV.make_mesh(), "4": SV.make_mesh(4, device=dev)}
            with tempfile.TemporaryDirectory() as tmp:
                counts = sharded_path(planes, meshes, dev, rng, chain_id, commits, bad_index, runs, tmp)
            kernels += kernels_at_sharded_shapes(planes, dev, rng, chain_id, commits, bad_index, counts, int32_rate)
            sharded_end_to_end(planes, meshes, dev, chain_id, commits, runs)
            log(f"phase 7: the sharded path in {time.perf_counter() - t0:.1f} s")
        if 8 in chosen:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                autotune_phase(tmp)
            log(f"phase 8: the autotune in {time.perf_counter() - t0:.1f} s")
        if 9 in chosen:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                engine_phase(planes, chain_id, commits, commits9, runs, tmp)
            log(f"phase 9: the engine in {time.perf_counter() - t0:.1f} s")
        if 10 in chosen:
            t0 = time.perf_counter()
            light_phase(planes, chain_id, chains10, runs)
            hash_phase(commits["ed25519"][SIZES[-1]][0], runs)
            mixed_phase(chain_id, mixed10, runs)
            log(f"phase 10: the light client and the hashes in {time.perf_counter() - t0:.1f} s")
        if 11 in chosen:
            t0 = time.perf_counter()
            client_phase(planes, chain_id, chains11, runs)
            log(f"phase 11: the light client's sync modes, witnesses and evidence in {time.perf_counter() - t0:.1f} s")
        if 12 in chosen:
            t0 = time.perf_counter()
            state_phase(planes, chain_id, built12, runs, tmp12)
            log(f"phase 12: the state layer's replay, rejections and light client in {time.perf_counter() - t0:.1f} s")
        if 13 in chosen:
            t0 = time.perf_counter()
            blocksync_phase(planes, chain_id, built12, runs, tmp12)
            log(f"phase 13: blocksync's hand-driven sync, refusals, extended commits and threaded sync in "
                f"{time.perf_counter() - t0:.1f} s")
        shutil.rmtree(tmp12, ignore_errors=True)
        sign = pool_signer(pool)
        if 14 in chosen:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="chip-smoke-consensus-") as tmp:
                consensus_phase(planes, chain_id, built14, runs, tmp, sign)
            log(f"phase 14: consensus on one node in {time.perf_counter() - t0:.1f} s")
        if 15 in chosen:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="chip-smoke-network-") as tmp:
                network_phase(planes, chain_id, built14, runs, tmp, sign)
            log(f"phase 15: the network over TCP in {time.perf_counter() - t0:.1f} s")
        if 16 in chosen:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
                cli_phase(planes, chain_id, built14, runs, tmp, sign)
            log(f"phase 16 (and 17 and 18, in its ed25519 network): the CLI-started nodes served over JSON-RPC, "
                f"the light daemon, its proxy and replay, state sync and the remote app clients in "
                f"{time.perf_counter() - t0:.1f} s")
    for r in runs:
        extra = {k: round(v, 5) for k, v in r.items() if k.endswith("_s") and k not in ("s", "sigs_per_s")}
        log(f"run: {r['plane']} {r['run']} on {r['commit']} validators"
            + (f" at S={r['splits']}" if "splits" in r else "")
            + (f", mesh of {r['mesh']}" if "mesh" in r else "") + f": {r['s'] * 1e3:.1f} ms"
            + (f", {r['sigs_per_s']:.0f} sigs/s" if "sigs_per_s" in r else "")
            + (f" {json.dumps(extra)}" if extra else "") + f" on {card()}")
    if chosen != ALL_PHASES:
        audit_or_fail()
        log(f"phases 1-3 and {sorted(chosen)} only, on {card_line}; total {time.perf_counter() - t_start:.1f} s; "
            f"no result line")
        return 0
    names = {k["name"].split("[")[0] for k in kernels}
    if names != set(KERNEL_SOURCES):
        raise AssertionError(f"kernels without a main-path record: {sorted(set(KERNEL_SOURCES) - names)}")
    audit_or_fail()
    log(f"card {card_line}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
