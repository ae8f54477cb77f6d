"""ProverChannel — the prover side of the simulated interaction
(prover/src/channel.rs:25-236)."""

from __future__ import annotations

from typing import List

from ..air.proof import Commitments, Context, OodFrame, Proof, Queries
from ..crypto import native
from ..crypto.hashers import Blake3_192, Blake3_256
from ..crypto.random_coin import DefaultRandomCoin
from ..math.fields import Field


class ProverChannel:
    def __init__(self, air, pub_inputs_elements: List[tuple], hasher):
        num_constraints = (
            air.context.num_assertions + air.context.num_transition_constraints
        )
        self.air = air
        self.hasher = hasher
        self.base_field = Field(air.base, 1)
        self.ext_field = air.ext_field
        self.context = Context.new(
            air.base, air.trace_info, air.options, num_constraints)
        # seed = Context::to_elements ‖ pub_inputs (channel.rs:57-82)
        seed_elements = self.context.to_elements(self.base_field) + list(pub_inputs_elements)
        self.public_coin = DefaultRandomCoin(hasher, seed_elements, self.base_field)
        self.commitments = Commitments()
        self.ood_frame = OodFrame()
        self.pow_nonce = 0

    # -- commitment methods --------------------------------------------------

    def commit_trace(self, trace_root: bytes) -> None:
        self.commitments.raw += trace_root
        self.public_coin.reseed(trace_root)

    def commit_constraints(self, constraint_root: bytes) -> None:
        self.commitments.raw += constraint_root
        self.public_coin.reseed(constraint_root)

    def send_ood_evaluations(self, trace_current, trace_next,
                             quot_current, quot_next) -> None:
        """Single reseed with the merged OOD evaluations (channel.rs:102-113)."""
        self.ood_frame = OodFrame.new(
            self.ext_field, trace_current, trace_next, quot_current, quot_next)
        merged = trace_current + quot_current + trace_next + quot_next
        digest = self.hasher.hash_elements(merged, self.ext_field)
        self.public_coin.reseed(digest)

    # -- public coin methods --------------------------------------------------

    def get_constraint_composition_coeffs(self):
        return self.air.get_constraint_composition_coefficients(self.public_coin)

    def get_ood_point(self) -> tuple:
        return self.public_coin.draw(self.ext_field)

    def get_deep_composition_coeffs(self):
        return self.air.get_deep_composition_coefficients(self.public_coin)

    def get_query_positions(self) -> List[int]:
        """Sorted, deduplicated (channel.rs:151-164)."""
        num_queries = self.context.options.num_queries
        lde_domain_size = self.context.lde_domain_size
        positions = self.public_coin.draw_integers(
            num_queries, lde_domain_size, self.pow_nonce)
        return sorted(set(positions))

    def grind_query_seed(self) -> None:
        """Serial first-found nonce scan (channel.rs:169-184). The serial scan
        makes the nonce deterministic, matching the reference's
        non-concurrent build. BLAKE3 coins scan in the native C library
        where it is built (the Python loop costs microseconds per nonce:
        tenths of a second at grinding 16), every other coin in the loop."""
        grinding_factor = self.context.options.grinding_factor
        if (self.hasher in (Blake3_256, Blake3_192) and native.available()
                and grinding_factor > 0):
            self.pow_nonce = native.blake3_grind(self.public_coin.seed,
                                                 grinding_factor)
            return
        nonce = 1
        while True:
            if self.public_coin.check_leading_zeros(nonce) >= grinding_factor:
                break
            nonce += 1
        self.pow_nonce = nonce

    # -- fri::ProverChannel (channel.rs:215-235) ------------------------------

    def commit_fri_layer(self, layer_root: bytes) -> None:
        self.commitments.raw += layer_root
        self.public_coin.reseed(layer_root)

    def draw_fri_alpha(self) -> tuple:
        return self.public_coin.draw(self.ext_field)

    # -- proof builder --------------------------------------------------------

    def build_proof(self, trace_queries: List[Queries], constraint_queries: Queries,
                    fri_proof, num_query_positions: int) -> Proof:
        assert num_query_positions <= 255
        return Proof(
            context=self.context,
            num_unique_queries=num_query_positions,
            commitments=self.commitments,
            trace_queries=trace_queries,
            constraint_queries=constraint_queries,
            ood_frame=self.ood_frame,
            fri_proof=fri_proof,
            pow_nonce=self.pow_nonce,
        )
