"""Joint-tree skeleton with left/right annotation and joint removal.

Parity with reference `skeleton.py:11-89`.
"""

from __future__ import annotations

import numpy as np


class Skeleton:
    def __init__(self, parents, joints_left, joints_right):
        assert len(joints_left) == len(joints_right)
        self._parents = np.array(parents)
        self._joints_left = list(joints_left)
        self._joints_right = list(joints_right)
        self._compute_metadata()

    def num_joints(self):
        return len(self._parents)

    def parents(self):
        return self._parents

    def has_children(self):
        return self._has_children

    def children(self):
        return self._children

    def joints_left(self):
        return self._joints_left

    def joints_right(self):
        return self._joints_right

    def remove_joints(self, joints_to_remove):
        """Drop the given joints, reparenting children to the nearest kept ancestor.

        Returns the list of kept (original) joint indices.
        """
        removed = set(joints_to_remove)
        valid_joints = [j for j in range(len(self._parents)) if j not in removed]

        for i in range(len(self._parents)):
            while self._parents[i] in removed:
                self._parents[i] = self._parents[self._parents[i]]

        index_offsets = np.zeros(len(self._parents), dtype=int)
        new_parents = []
        for i, parent in enumerate(self._parents):
            if i not in removed:
                new_parents.append(parent - index_offsets[parent])
            else:
                index_offsets[i:] += 1
        self._parents = np.array(new_parents)

        self._joints_left = [j - index_offsets[j] for j in self._joints_left if j in valid_joints]
        self._joints_right = [j - index_offsets[j] for j in self._joints_right if j in valid_joints]

        self._compute_metadata()
        return valid_joints

    def _compute_metadata(self):
        n = len(self._parents)
        self._has_children = np.zeros(n, dtype=bool)
        self._children = [[] for _ in range(n)]
        for child, parent in enumerate(self._parents):
            if parent != -1:
                self._has_children[parent] = True
                self._children[parent].append(child)
