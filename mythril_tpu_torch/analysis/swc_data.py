"""SWC registry id <-> title tables (reference parity: analysis/swc_data.py:1-67)."""

INTEGER_OVERFLOW_AND_UNDERFLOW = "101"
OUTDATED_COMPILER_VERSION = "102"
FLOATING_PRAGMA = "103"
UNCHECKED_RET_VAL = "104"
UNPROTECTED_ETHER_WITHDRAWAL = "105"
UNPROTECTED_SELFDESTRUCT = "106"
REENTRANCY = "107"
DEFAULT_VISIBILITY_STATE = "108"
UNINITIALIZED_STORAGE_POINTER = "109"
ASSERT_VIOLATION = "110"

# Panic(uint256) error selector (solc >= 0.8 assert/panic reverts); shared
# by the Exceptions (revert-data scan) and UserAssertions (MSTORE value
# gate) modules so the two encodings cannot drift
PANIC_SELECTOR = 0x4E487B71
PANIC_SELECTOR_BYTES = list(PANIC_SELECTOR.to_bytes(4, "big"))
DEPRECATED_FUNCTIONS_USAGE = "111"
DELEGATECALL_TO_UNTRUSTED_CONTRACT = "112"
MULTIPLE_SENDS = "113"
TX_ORDER_DEPENDENCE = "114"
TX_ORIGIN_USAGE = "115"
TIMESTAMP_DEPENDENCE = "116"
SIGNATURE_MALLEABILITY = "117"
INCORRECT_CONSTRUCTOR_NAME = "118"
SHADOWING_STATE_VARIABLES = "119"
WEAK_RANDOMNESS = "120"
SIGNATURE_REPLAY = "121"
IMPROPER_VERIFICATION_ON_SIG = "122"
REQUIREMENT_VIOLATION = "123"
WRITE_TO_ARBITRARY_STORAGE = "124"
INCORRECT_INHERITANCE_ORDER = "125"
INSUFFICIENT_GAS_GRIEFING = "126"
ARBITRARY_JUMP = "127"
DOS_WITH_BLOCK_GAS_LIMIT = "128"
TYPOGRAPHICAL_ERROR = "129"
RIGHT_TO_LEFT_OVERRIDE = "130"
PRESENCE_OF_UNUSED_VARIABLES = "131"
UNEXPECTED_ETHER_BALANCE = "132"
HASH_COLLISION = "133"
MESSAGE_CALL_WITH_HARDCODED_GAS = "134"
CODE_WITH_NO_EFFECTS = "135"
UNENCRYPTED_PRIVATE_DATA = "136"

SWC_TO_TITLE = {
    "100": "Function Default Visibility",
    "101": "Integer Overflow and Underflow",
    "102": "Outdated Compiler Version",
    "103": "Floating Pragma",
    "104": "Unchecked Call Return Value",
    "105": "Unprotected Ether Withdrawal",
    "106": "Unprotected SELFDESTRUCT Instruction",
    "107": "Reentrancy",
    "108": "State Variable Default Visibility",
    "109": "Uninitialized Storage Pointer",
    "110": "Assert Violation",
    "111": "Use of Deprecated Solidity Functions",
    "112": "Delegatecall to Untrusted Callee",
    "113": "DoS with Failed Call",
    "114": "Transaction Order Dependence",
    "115": "Authorization through tx.origin",
    "116": "Block values as a proxy for time",
    "117": "Signature Malleability",
    "118": "Incorrect Constructor Name",
    "119": "Shadowing State Variables",
    "120": "Weak Sources of Randomness from Chain Attributes",
    "121": "Missing Protection against Signature Replay Attacks",
    "122": "Lack of Proper Signature Verification",
    "123": "Requirement Violation",
    "124": "Write to Arbitrary Storage Location",
    "125": "Incorrect Inheritance Order",
    "126": "Insufficient Gas Griefing",
    "127": "Arbitrary Jump with Function Type Variable",
    "128": "DoS With Block Gas Limit",
    "129": "Typographical Error",
    "130": "Right-To-Left-Override control character (U+202E)",
    "131": "Presence of unused variables",
    "132": "Unexpected Ether balance",
    "133": "Hash Collisions With Multiple Variable Length Arguments",
    "134": "Message call with hardcoded gas amount",
    "135": "Code With No Effects",
    "136": "Unencrypted Private Data On-Chain",
}
