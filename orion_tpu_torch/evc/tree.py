"""Generic tree with traversals and recursive map (port of
``orion_tpu/evc/tree.py``).

Capability parity: reference `src/orion/core/evc/tree.py` — `TreeNode` with
parent/children management, `map(function, node)` recursive application in
either direction, pre-order and depth-first traversals, `flattened`.
"""


class TreeNode:
    def __init__(self, item, parent=None, children=()):
        self.item = item
        self._parent = None
        self._children = []
        self.set_parent(parent)
        for child in children:
            self.add_children(child)

    @property
    def parent(self):
        return self._parent

    @property
    def children(self):
        return list(self._children)

    def set_parent(self, node):
        if self._parent is node:
            return
        if self._parent is not None:
            self._parent.drop_children(self)
        self._parent = node
        if node is not None and self not in node._children:
            node._children.append(self)

    def add_children(self, *nodes):
        for node in nodes:
            if node._parent is not None and node._parent is not self:
                node._parent.drop_children(node)
            node._parent = self
            if node not in self._children:
                self._children.append(node)

    def drop_children(self, *nodes):
        for node in nodes:
            self._children.remove(node)
            node._parent = None

    @property
    def root(self):
        return self if self._parent is None else self._parent.root

    @property
    def leafs(self):
        if not self._children:
            return [self]
        out = []
        for child in self._children:
            out.extend(child.leafs)
        return out

    def map(self, function, node):
        """Apply ``function(self_item, mapped_neighbor)`` towards ``node``.

        When ``node`` is the parent, mapping ascends (the reference's
        parent-ward map used to adapt trials rootward); when it is a child
        list direction descends.
        """
        if node is None:
            return TreeNode(function(self, None))
        if node is self._parent:
            mapped_parent = node.map(function, node.parent) if node else None
            return TreeNode(function(self, mapped_parent), parent=mapped_parent)
        raise ValueError("map target must be the parent node or None")

    def __iter__(self):
        return PreOrderTraversal(self)

    @property
    def flattened(self):
        return [node.item for node in self]

    def __repr__(self):
        return f"TreeNode({self.item!r}, children={len(self._children)})"


class PreOrderTraversal:
    """Root, then each subtree left-to-right."""

    def __init__(self, node):
        self.stack = [node]

    def __iter__(self):
        return self

    def __next__(self):
        if not self.stack:
            raise StopIteration
        node = self.stack.pop(0)
        self.stack = node.children + self.stack
        return node


class DepthFirstTraversal:
    """Children before parents (post-order)."""

    def __init__(self, node):
        self.order = []
        self._build(node)

    def _build(self, node):
        for child in node.children:
            self._build(child)
        self.order.append(node)

    def __iter__(self):
        return iter(self.order)
