"""State store: the State, the validator sets and consensus params of each
height, and the FinalizeBlock responses (ref:
internal/state/store.go:91-530). Keys and values are the JAX package's, so
either package carries on from a store the other wrote.

Validator sets are stored sparsely: the full set only at the height it
changed, and at other heights a pointer to last_height_changed (ref:
SaveValidatorSets store.go:491, the `valInfo.ValidatorSet == nil`
indirection in loadValidatorsInfo).
"""

from __future__ import annotations

import json

from ..proto import messages as pb
from ..store.kv import KVStore
from ..types.block import BlockID, PartSetHeader
from ..types.genesis import _b64, _params_from_json, _params_to_json, _unb64
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet
from ..utils.tmtime import Time
from .state import State

KEY_STATE = b"stateKey"
KEY_VALIDATORS = b"validatorsKey:"
KEY_PARAMS = b"consensusParamsKey:"
KEY_ABCI_RESPONSES = b"abciResponsesKey:"


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


def _events_to_json(events) -> list:
    return [
        {"type": e.type, "attributes": [{"key": a.key, "value": a.value, "index": a.index} for a in e.attributes]}
        for e in events
    ]


def _events_from_json(docs: list):
    from ..abci import types as abci

    return [
        abci.Event(
            type=d["type"],
            attributes=[abci.EventAttribute(a["key"], a["value"], a["index"]) for a in d["attributes"]],
        )
        for d in docs
    ]


def state_to_json(state: State) -> dict:
    return {
        "chain_id": state.chain_id,
        "initial_height": state.initial_height,
        "last_block_height": state.last_block_height,
        "last_block_id": {
            "hash": _b64(state.last_block_id.hash),
            "total": state.last_block_id.part_set_header.total,
            "psh_hash": _b64(state.last_block_id.part_set_header.hash),
        },
        "last_block_time": state.last_block_time.unix_ns(),
        "validators": _b64(state.validators.to_proto().encode()),
        "next_validators": _b64(state.next_validators.to_proto().encode()),
        "last_validators": _b64(state.last_validators.to_proto().encode()),
        "last_height_validators_changed": state.last_height_validators_changed,
        "consensus_params": _params_to_json(state.consensus_params),
        "last_height_consensus_params_changed": state.last_height_consensus_params_changed,
        "last_results_hash": _b64(state.last_results_hash),
        "app_hash": _b64(state.app_hash),
        "version_block": state.version_block,
        "version_app": state.version_app,
    }


def state_from_json(doc: dict) -> State:
    def vs(key: str) -> ValidatorSet:
        raw = _unb64(doc[key])
        if not raw:
            return ValidatorSet([])
        return ValidatorSet.from_proto(pb.ValidatorSet.decode(raw))

    bid = doc["last_block_id"]
    return State(
        chain_id=doc["chain_id"],
        initial_height=doc["initial_height"],
        last_block_height=doc["last_block_height"],
        last_block_id=BlockID(
            hash=_unb64(bid["hash"]),
            part_set_header=PartSetHeader(total=bid["total"], hash=_unb64(bid["psh_hash"])),
        ),
        last_block_time=Time.from_unix_ns(doc["last_block_time"]),
        validators=vs("validators"),
        next_validators=vs("next_validators"),
        last_validators=vs("last_validators"),
        last_height_validators_changed=doc["last_height_validators_changed"],
        consensus_params=_params_from_json(doc["consensus_params"]),
        last_height_consensus_params_changed=doc["last_height_consensus_params_changed"],
        last_results_hash=_unb64(doc["last_results_hash"]),
        app_hash=_unb64(doc["app_hash"]),
        version_block=doc.get("version_block", 11),
        version_app=doc.get("version_app", 0),
    )


class StateStore:
    """ref: sm.Store (internal/state/store.go:47-91)."""

    def __init__(self, db: KVStore):
        self._db = db

    # ----------------------------------------------------------- state

    def load(self) -> State | None:
        raw = self._db.get(KEY_STATE)
        if not raw:
            return None
        return state_from_json(json.loads(raw))

    def save(self, state: State) -> None:
        """Persist state + the validator set / params it implies for the
        next height (ref: store.go Save:157)."""
        # At genesis the "next" height is initial_height, not 1
        # (ref: store.go Save:165 nextHeight = state.InitialHeight).
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:
            next_height = state.initial_height
            # initial state: bootstrap the current set
            self.save_validator_sets(state.initial_height, state.last_height_validators_changed, state.validators)
        # The next-height entry carries last_height_validators_changed: a
        # sparse pointer while the set is unchanged (store.go Save:169), so
        # that every entry agrees on where the checkpoint lives, which
        # prune_states' keep logic relies on.
        self.save_validator_sets(next_height + 1, state.last_height_validators_changed, state.next_validators)
        self._save_params(next_height, state.last_height_consensus_params_changed, state.consensus_params)
        self._db.set(KEY_STATE, json.dumps(state_to_json(state)).encode())

    def bootstrap(self, state: State) -> None:
        """ref: store.go Bootstrap, used by statesync."""
        height = state.last_block_height + 1
        if height > 1 and state.last_validators.size() > 0:
            self.save_validator_sets(height - 1, height - 1, state.last_validators)
        self.save_validator_sets(height, height, state.validators)
        self.save_validator_sets(height + 1, height + 1, state.next_validators)
        # the params pinned at the bootstrap height, as the validator
        # entries above (ref store.go Bootstrap): a sparse pointer would
        # name a height that a state-synced store never stored
        self._save_params(height, height, state.consensus_params)
        self._db.set(KEY_STATE, json.dumps(state_to_json(state)).encode())

    # ------------------------------------------------- validator sets

    def save_validator_sets(self, height: int, last_height_changed: int, val_set: ValidatorSet) -> None:
        if last_height_changed > height:
            last_height_changed = height
        doc = {"last_height_changed": last_height_changed}
        if height == last_height_changed:
            doc["validator_set"] = _b64(val_set.to_proto().encode())
        self._db.set(_hkey(KEY_VALIDATORS, height), json.dumps(doc).encode())

    def load_validators(self, height: int) -> ValidatorSet | None:
        """ref: store.go LoadValidators: follow the sparse pointer, then
        re-derive the proposer priorities by incrementing from the
        checkpoint."""
        raw = self._db.get(_hkey(KEY_VALIDATORS, height))
        if raw is None:
            return None
        doc = json.loads(raw)
        if "validator_set" in doc:
            return ValidatorSet.from_proto(pb.ValidatorSet.decode(_unb64(doc["validator_set"])))
        last_changed = doc["last_height_changed"]
        raw2 = self._db.get(_hkey(KEY_VALIDATORS, last_changed))
        if raw2 is None:
            return None
        doc2 = json.loads(raw2)
        if "validator_set" not in doc2:
            return None
        vals = ValidatorSet.from_proto(pb.ValidatorSet.decode(_unb64(doc2["validator_set"])))
        vals.increment_proposer_priority(height - last_changed)
        return vals

    # ---------------------------------------------------------- params

    def _save_params(self, height: int, last_height_changed: int, params: ConsensusParams) -> None:
        doc = {"last_height_changed": last_height_changed}
        if height == last_height_changed:
            doc["params"] = _params_to_json(params)
        self._db.set(_hkey(KEY_PARAMS, height), json.dumps(doc).encode())

    def load_consensus_params(self, height: int) -> ConsensusParams | None:
        raw = self._db.get(_hkey(KEY_PARAMS, height))
        if raw is None:
            return None
        doc = json.loads(raw)
        if "params" in doc:
            return _params_from_json(doc["params"])
        raw2 = self._db.get(_hkey(KEY_PARAMS, doc["last_height_changed"]))
        if raw2 is None:
            return None
        doc2 = json.loads(raw2)
        if "params" not in doc2:
            return None
        return _params_from_json(doc2["params"])

    # ------------------------------------------- finalize-block responses

    def save_finalize_block_responses(self, height: int, resp) -> None:
        """Persist the ABCI FinalizeBlock response for replay/indexing
        (ref: store.go SaveFinalizeBlockResponses:461)."""
        doc = {
            "app_hash": _b64(resp.app_hash),
            "tx_results": [
                {
                    "code": r.code,
                    "data": _b64(r.data),
                    "log": r.log,
                    "gas_wanted": r.gas_wanted,
                    "gas_used": r.gas_used,
                    "events": _events_to_json(r.events),
                }
                for r in resp.tx_results
            ],
            "validator_updates": [
                {"pub_key_type": u.pub_key_type, "pub_key": _b64(u.pub_key_bytes), "power": u.power}
                for u in resp.validator_updates
            ],
            "consensus_param_updates": (
                _b64(resp.consensus_param_updates.encode()) if resp.consensus_param_updates is not None else None
            ),
            "events": _events_to_json(resp.events),
        }
        self._db.set(_hkey(KEY_ABCI_RESPONSES, height), json.dumps(doc).encode())

    def load_finalize_block_responses(self, height: int):
        from ..abci import types as abci

        raw = self._db.get(_hkey(KEY_ABCI_RESPONSES, height))
        if raw is None:
            return None
        doc = json.loads(raw)
        cpu = doc.get("consensus_param_updates")
        return abci.ResponseFinalizeBlock(
            app_hash=_unb64(doc["app_hash"]),
            tx_results=[
                abci.ExecTxResult(
                    code=r["code"],
                    data=_unb64(r["data"]),
                    log=r["log"],
                    gas_wanted=r["gas_wanted"],
                    gas_used=r["gas_used"],
                    events=_events_from_json(r.get("events", [])),
                )
                for r in doc["tx_results"]
            ],
            validator_updates=[
                abci.ValidatorUpdate(pub_key_type=u["pub_key_type"], pub_key_bytes=_unb64(u["pub_key"]), power=u["power"])
                for u in doc["validator_updates"]
            ],
            consensus_param_updates=pb.ConsensusParamsUpdate.decode(_unb64(cpu)) if cpu else None,
            events=_events_from_json(doc.get("events", [])),
        )

    # --------------------------------------------------------- pruning

    def prune_states(self, retain_height: int) -> int:
        """Delete validator-set/params/response entries below retain_height
        (ref: store.go PruneStates:244). Keeps the entry retain_height
        points at so sparse lookups still resolve."""
        if retain_height <= 0:
            raise ValueError(f"height {retain_height} must be greater than 0")
        pruned = 0
        # Keep every height below retain_height that a surviving sparse
        # entry points at, not only the target of the entry at
        # retain_height: mixed full and sparse histories (a restarted node,
        # a statesync bootstrap) can leave entries above retain_height that
        # name an older checkpoint. The scan covers the surviving window.
        keep = set()
        keep_params = set()
        for prefix, keepset in ((KEY_VALIDATORS, keep), (KEY_PARAMS, keep_params)):
            for k, v in self._db.iterator(_hkey(prefix, retain_height), prefix + b"\xff" * 9):
                target = json.loads(v).get("last_height_changed")
                if target is not None and target < retain_height:
                    keepset.add(target)
        batch = self._db.batch()
        for prefix, keepset in ((KEY_VALIDATORS, keep), (KEY_PARAMS, keep_params), (KEY_ABCI_RESPONSES, set())):
            for k, _ in list(self._db.iterator(prefix, _hkey(prefix, retain_height))):
                h = int.from_bytes(k[len(prefix):], "big")
                if h in keepset:
                    continue
                batch.delete(k)
                pruned += 1
        batch.write()
        return pruned
