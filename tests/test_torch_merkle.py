"""The port's Merkle tree (winterfell_tpu_torch.crypto.merkle: MerkleTree,
BatchMerkleProof) against the reference's own test vectors
(crypto/src/merkle/tests.rs), as tests/test_reference_merkle_fixtures.py
holds the JAX package's: new tree, prove, verify, prove_batch,
verify_batch and from_proofs over the constant leaf sets LEAVES4 and
LEAVES8. The port's tree hashes with the port's Blake3_256; every expected
node is a merge by the JAX package's Blake3_256 (hash_2x1, tests.rs:316-318),
which tests/test_hashers_kat.py pins to the official BLAKE3 vectors."""

import pytest

from tests.test_reference_merkle_fixtures import LEAVES4, LEAVES8
from winterfell_tpu.crypto.hashers import Blake3_256 as RefBlake3_256
from winterfell_tpu_torch.crypto.hashers import Blake3_256
from winterfell_tpu_torch.crypto.merkle import BatchMerkleProof, MerkleTree


def h2(a: bytes, b: bytes) -> bytes:
    return RefBlake3_256.merge(a, b)


def _single_paths(leaves):
    """new_tree, prove and verify (tests.rs:68-136) over one leaf set."""
    L = leaves
    tree = MerkleTree(L, Blake3_256)
    if len(L) == 4:
        assert tree.depth == 2
        assert tree.root == h2(h2(L[0], L[1]), h2(L[2], L[3]))
        assert tree.prove(1) == (L[1], [L[0], h2(L[2], L[3])])
        assert tree.prove(2) == (L[2], [L[3], h2(L[0], L[1])])
        indexes = (1, 2)
    else:
        assert tree.depth == 3
        assert tree.root == h2(h2(h2(L[0], L[1]), h2(L[2], L[3])),
                               h2(h2(L[4], L[5]), h2(L[6], L[7])))
        assert tree.prove(1) == (L[1], [
            L[0], h2(L[2], L[3]), h2(h2(L[4], L[5]), h2(L[6], L[7]))])
        assert tree.prove(6) == (L[6], [
            L[7], h2(L[4], L[5]), h2(h2(L[0], L[1]), h2(L[2], L[3]))])
        indexes = (1, 6)
    for idx in indexes:
        leaf, proof = tree.prove(idx)
        MerkleTree.verify(tree.root, idx, leaf, proof, Blake3_256)
    return tree


def _batches(tree, L):
    """prove_batch, verify_batch and from_proofs (tests.rs:138-255) over
    LEAVES8."""
    values, proof = tree.prove_batch([1])
    assert values == [L[1]] and proof.depth == 3
    assert proof.nodes == [[L[0], h2(L[2], L[3]),
                            h2(h2(L[4], L[5]), h2(L[6], L[7]))]]
    MerkleTree.verify_batch(tree.root, [1], values, proof, Blake3_256)
    with pytest.raises(Exception):
        MerkleTree.verify_batch(tree.root, [2], values, proof, Blake3_256)

    values, proof = tree.prove_batch([1, 2])
    assert values == [L[1], L[2]] and proof.depth == 3
    assert proof.nodes == [[L[0], h2(h2(L[4], L[5]), h2(L[6], L[7]))],
                           [L[3]]]
    MerkleTree.verify_batch(tree.root, [1, 2], values, proof, Blake3_256)
    for bad in ([1], [1, 3], [1, 2, 3]):
        with pytest.raises(Exception):
            MerkleTree.verify_batch(tree.root, bad, values, proof,
                                    Blake3_256)
    singles = [tree.prove(i) for i in (1, 2)]
    joined = BatchMerkleProof.from_single_proofs(singles, [1, 2])
    assert joined.nodes == proof.nodes and joined.depth == proof.depth

    values, proof = tree.prove_batch([1, 6])
    assert values == [L[1], L[6]] and proof.depth == 3
    assert proof.nodes == [[L[0], h2(L[2], L[3])], [L[7], h2(L[4], L[5])]]
    MerkleTree.verify_batch(tree.root, [1, 6], values, proof, Blake3_256)

    values, proof = tree.prove_batch([1, 3, 6])
    MerkleTree.verify_batch(tree.root, [1, 3, 6], values, proof, Blake3_256)

    values, proof = tree.prove_batch(list(range(8)))
    assert values == L and proof.nodes == [[], [], [], []]
    assert proof.depth == 3
    MerkleTree.verify_batch(tree.root, list(range(8)), values, proof,
                            Blake3_256)


@pytest.mark.parametrize("n_leaves", [4, 8])
def test_port_merkle_matches_reference_vectors(n_leaves):
    leaves = LEAVES4 if n_leaves == 4 else LEAVES8
    tree = _single_paths(leaves)
    if n_leaves == 8:
        _batches(tree, leaves)
